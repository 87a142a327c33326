// Greedy-NMS proposal selection for Hopper (sm_90a), one thread block per image.
//
// Replaces tpurpn/kernels/proposal_pallas.py::fused_proposals_packed (body
// _proposal_kernel). It takes what that kernel computes, not its TPU
// workarounds: the 3-way bf16 split, the page one-hot MXU gather and the
// 8-image group exist only because Mosaic has no exact f32 lane gather. Here
// each block reads its image's f32 boxes directly through the score order.
//
// Input: boxes (B, N, 4) f32 [y1,x1,y2,x2], scores (B, N) f32, and order
// (B, pre) int64, the stable descending score order (ties to the lower index,
// as lax.top_k) that the wrapper computes outside the kernel, as tpurpn does.
// Output: the first max_output kept boxes in score order with their scores,
// zero past num_valid, and num_valid (B,) int32.
//
// What bounds it: the greedy chain. Candidate j can only be decided after
// every earlier keep is known, so an image is a sequence of up to `pre`
// dependent decisions; the data read is at most pre*20 bytes per image
// (B=128, pre=6000: 15.4 MB, about 5 us at 3.35 TB/s). The design keeps the
// chain on chip: the candidates of a 256-wide chunk are gathered into shared
// memory by all threads at once, the kept boxes live in shared memory, and
// each decision is one IoU sweep over the kept boxes spread across the
// block's threads plus one __syncthreads_or. Slot k of the kept buffer is
// written and read only by thread k % blockDim, so an append needs no extra
// barrier. The loop stops at max_output keeps.
//
// Exactness: the IoU is computed op for op as tpurpn.boxes.generate_iou_map
// (area = max(y2-y1,0)*max(x2-x1,0); inter / max(area_c + area_r - inter,
// 1e-8) > thr). The file is built with -fmad=false and without fast math, so
// no product is contracted into an FMA and the division is IEEE: selection
// flips on 1-ulp differences otherwise.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // also the candidate chunk width

__global__ void __launch_bounds__(kThreads) proposal_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const long long* __restrict__ order, float* __restrict__ roi_boxes,
    float* __restrict__ roi_scores, int* __restrict__ num_valid, int N, int pre,
    int max_output, float iou_threshold) {
  extern __shared__ float smem[];
  float* ky1 = smem;  // kept boxes, slot k owned by thread k % kThreads
  float* kx1 = ky1 + max_output;
  float* ky2 = kx1 + max_output;
  float* kx2 = ky2 + max_output;
  float* karea = kx2 + max_output;
  float* cy1 = karea + max_output;  // the current chunk of candidates
  float* cx1 = cy1 + kThreads;
  float* cy2 = cx1 + kThreads;
  float* cx2 = cy2 + kThreads;
  float* carea = cx2 + kThreads;
  float* cscore = carea + kThreads;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)b * N;
  const float* sc = scores + (size_t)b * N;
  const long long* od = order + (size_t)b * pre;
  float* ob = roi_boxes + (size_t)b * max_output * 4;
  float* os = roi_scores + (size_t)b * max_output;

  int kept = 0;  // uniform across the block
  for (int start = 0; start < pre && kept < max_output; start += kThreads) {
    const int n = min(kThreads, pre - start);
    __syncthreads();  // the previous chunk is no longer read
    if (t < n) {
      const long long i = od[start + t];
      const float4 v = bx[i];
      cy1[t] = v.x;
      cx1[t] = v.y;
      cy2[t] = v.z;
      cx2[t] = v.w;
      carea[t] = box_area(v.x, v.y, v.z, v.w);
      cscore[t] = sc[i];
    }
    __syncthreads();
    for (int j = 0; j < n && kept < max_output; ++j) {
      const float y1 = cy1[j], x1 = cx1[j], y2 = cy2[j], x2 = cx2[j];
      const float4 cand = make_float4(y1, x1, y2, x2);
      const float area_c = carea[j];
      // a score <= -inf (or NaN) is no candidate, as in the plain version
      int hit = !(cscore[j] > -INFINITY);
      for (int k = t; k < kept && !hit; k += kThreads) {
        const float4 kb = make_float4(ky1[k], kx1[k], ky2[k], kx2[k]);
        hit = box_iou(cand, area_c, kb, karea[k]) > iou_threshold;
      }
      if (!__syncthreads_or(hit)) {
        if (kept % kThreads == t) {
          ky1[kept] = y1;
          kx1[kept] = x1;
          ky2[kept] = y2;
          kx2[kept] = x2;
          karea[kept] = area_c;
          reinterpret_cast<float4*>(ob)[kept] = make_float4(y1, x1, y2, x2);
          os[kept] = cscore[j];
        }
        ++kept;
      }
    }
  }
  for (int k = kept + t; k < max_output; k += kThreads) {
    reinterpret_cast<float4*>(ob)[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    os[k] = 0.0f;
  }
  if (t == 0) num_valid[b] = kept;
}

}  // namespace

TPURPN_EXPORT int proposal_select(const float* boxes, const float* scores,
                                  const long long* order, float* roi_boxes,
                                  float* roi_scores, int* num_valid, int B, int N,
                                  int pre, int max_output, float iou_threshold,
                                  cudaStream_t stream) {
  if (B <= 0 || pre <= 0 || pre > N || max_output <= 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(5 * max_output + 6 * kThreads) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      proposal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  proposal_kernel<<<B, kThreads, smem, stream>>>(boxes, scores, order, roi_boxes,
                                                 roi_scores, num_valid, N, pre,
                                                 max_output, iou_threshold);
  return cudaGetLastError();
}

TPURPN_EXPORT const char* proposal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
