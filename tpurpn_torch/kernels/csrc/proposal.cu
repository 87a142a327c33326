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
// A score <= -inf (or NaN) is no candidate. Output: the first max_output
// kept boxes in score order with their scores, zero past num_valid, and
// num_valid (B,) int32.
//
// What bounds it: the greedy chain. Candidate j can only be decided after
// every earlier keep is known; the work is one IoU test of each visited
// candidate against the boxes kept before it (up to the last keep), a few
// microseconds of f32 work over the card, and the data read is at most
// pre*20 bytes an image (B=128, pre=6000: 15.4 MB, about 5 us at 3.35 TB/s).
// The chain of decisions, not the work, sets the time.
//
// Design: the block (1,024 threads; one block per SM at B=128 on 132 SMs)
// gathers a page of 1,024 candidates into shared memory, then decides them
// 32 at a time, as the TPU kernel decides a block of candidates at once. A
// round has two barriers:
//   (a) warp w takes candidate w of the chunk. Its lanes test it against the
//       kept boxes 32 at a time and stop at the first hit (one vote a
//       step), so a suppressed candidate usually costs a step or two;
//   (b) the same warp builds the candidate's in-chunk row in one ballot:
//       lane j < w votes IoU(w, j) > thr;
//   -- barrier --
//   (the tests of (a) and (b) are common.cuh's kept_suppresses and
//   chunk_row, shared with nms.cu)
//   (c) warp 0 resolves the chunk with chunk_walk (common.cuh): a ballot
//       fixpoint over the rows, a step per link of the longest suppression
//       chain, stopping exactly at max_output keeps even inside the chunk;
//       the keeps are appended to the kept list.
//   -- barrier --
// Overlap is tested before the division (iou_above, common.cuh): boxes
// that do not overlap have IoU +-0 exactly, and most pairs do not.
// The kept list (min(max_output, pre) boxes and scores) lives in shared
// memory: 24 KB for the page plus 24 bytes a kept box, 31 KB at
// max_output = 300; the block writes it out, coalesced, at the end.
//
// Levels (proposal_select_levels, the kernel proposal_kernel_levels): with a
// level id per candidate, a box suppresses only boxes of its own level and the
// kept sequence is detectron2's batched_nms by level (greedy NMS within each
// level, the keeps merged in the given score order), cut at max_output. The
// page and the kept list carry the ids (4 bytes a slot more); a candidate is
// tested against the kept boxes of its level alone. Both kernels inline one
// body (select_image<kLevels>), so the single-level instance is the code it
// was before levels existed.
//
// Exactness: the IoU is computed op for op as tpurpn.boxes.generate_iou_map
// (box_iou in common.cuh; area = max(y2-y1,0)*max(x2-x1,0); inter /
// max(area_c + area_r - inter, 1e-8) > thr), symmetric bit for bit. The
// file is built with -fmad=false and without fast math, so no product is
// contracted into an FMA and the division is IEEE: selection flips on 1-ulp
// differences otherwise.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;  // also the page of candidates gathered at once
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;      // candidates decided a round, one a warp
constexpr size_t kSmemLimit = 220 * 1024;  // dynamic, beside the static arrays
static_assert(kWarps == kChunk, "one warp a candidate of the chunk");

size_t smem_bytes(int cap, bool levels) {
  return (size_t)kThreads * 24 + (size_t)cap * 24 + (levels ? (size_t)(kThreads + cap) * 4 : 0);
}

// chunk_row and kept_suppresses (common.cuh) with a box suppressing only boxes
// of its own level when kLevels; without, the common helpers themselves.
template <bool kLevels>
__device__ __forceinline__ uint32_t level_row(float4 v, float a, int lv, const float4* cbox,
                                              const float* carea, const int* clev, int w,
                                              float thr) {
  if constexpr (!kLevels) {
    return chunk_row(v, a, cbox, carea, w, thr);
  } else {
    const int lane = lane_id();
    return __ballot_sync(0xffffffffu, lane < w && clev[lane] == lv &&
                                          iou_above(v, a, cbox[lane], carea[lane], thr));
  }
}

template <bool kLevels>
__device__ __forceinline__ bool level_kept_suppresses(float4 v, float a, int lv,
                                                      const float4* kbox, const float* karea,
                                                      const int* klev, int kept, float thr) {
  if constexpr (!kLevels) {
    return kept_suppresses(v, a, kbox, karea, kept, thr);
  } else {
    const int lane = lane_id();
    int hit = 0;
    for (int k0 = 0; k0 < kept && !hit; k0 += 32) {
      const int k = k0 + lane;
      hit = __any_sync(0xffffffffu, k < kept && klev[k] == lv &&
                                        iou_above(v, a, kbox[k], karea[k], thr));
    }
    return hit;
  }
}

// One image's selection (block b); levels is (N,) int, one id a candidate
// index, read only when kLevels.
template <bool kLevels>
__device__ __forceinline__ void select_image(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const long long* __restrict__ order, const int* __restrict__ levels,
    float* __restrict__ roi_boxes, float* __restrict__ roi_scores, int* __restrict__ num_valid,
    int N, int pre, int max_output, int cap, float iou_threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* cbox = reinterpret_cast<float4*>(smem);  // the page of candidates
  float* carea = reinterpret_cast<float*>(cbox + kThreads);
  float* cscore = carea + kThreads;
  float4* kbox = reinterpret_cast<float4*>(cscore + kThreads);  // kept boxes
  float* karea = reinterpret_cast<float*>(kbox + cap);
  float* kscore = karea + cap;
  int* clev = reinterpret_cast<int*>(kscore + cap);  // with kLevels only
  int* klev = clev + kThreads;
  __shared__ uint32_t s_row[kChunk];
  __shared__ int s_hit[kChunk];
  __shared__ int s_kept;

  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)b * N;
  const float* sc = scores + (size_t)b * N;
  const long long* od = order + (size_t)b * pre;
  float4* ob = reinterpret_cast<float4*>(roi_boxes) + (size_t)b * max_output;
  float* os = roi_scores + (size_t)b * max_output;

  int kept = 0;  // uniform across the block
  for (int page = 0; page < pre && kept < max_output; page += kThreads) {
    const int n_page = min(kThreads, pre - page);
    __syncthreads();  // the previous page is no longer read
    if (t < n_page) {
      const long long i = od[page + t];
      const float4 v = bx[i];
      cbox[t] = v;
      carea[t] = box_area(v);
      cscore[t] = sc[i];
      if constexpr (kLevels) clev[t] = levels[i];
    }
    __syncthreads();
    for (int c0 = 0; c0 < n_page && kept < max_output; c0 += kChunk) {
      const int n = min(kChunk, n_page - c0);
      // a score <= -inf (or NaN) is no candidate, as in the plain version
      const int w = c0 + warp;  // this warp's candidate
      if (warp < n && cscore[w] > -INFINITY) {
        const float4 v = cbox[w];
        const float a = carea[w];
        const int lv = kLevels ? clev[w] : 0;
        // (b) bit j: candidate j < w of the chunk suppresses w
        const uint32_t row = level_row<kLevels>(v, a, lv, cbox + c0, carea + c0, clev + c0,
                                                warp, iou_threshold);
        // (a) any box kept before the chunk suppresses w
        const int hit = level_kept_suppresses<kLevels>(v, a, lv, kbox, karea, klev, kept,
                                                       iou_threshold);
        if (lane == 0) {
          s_row[warp] = row;
          s_hit[warp] = hit;
        }
      } else if (lane == 0) {
        s_row[warp] = 0;
        s_hit[warp] = 1;  // no candidate: never kept
      }
      __syncthreads();
      if (warp == 0) {  // (c) resolve the chunk in order
        const int i = c0 + lane;
        const uint32_t alive = __ballot_sync(0xffffffffu, !s_hit[lane]);
        const uint32_t keep = chunk_walk(alive, s_row[lane], max_output - kept);
        if ((keep >> lane) & 1u) {
          const int pos = kept + __popc(keep & ((1u << lane) - 1u));
          kbox[pos] = cbox[i];
          karea[pos] = carea[i];
          kscore[pos] = cscore[i];
          if constexpr (kLevels) klev[pos] = clev[i];
        }
        if (lane == 0) s_kept = kept + __popc(keep);
      }
      __syncthreads();  // the appended boxes and the count are visible
      kept = s_kept;
    }
  }
  for (int k = t; k < max_output; k += kThreads) {  // the keeps, then zeros
    ob[k] = k < kept ? kbox[k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    os[k] = k < kept ? kscore[k] : 0.0f;
  }
  if (t == 0) num_valid[b] = kept;
}

__global__ void __launch_bounds__(kThreads, 1) proposal_kernel(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const long long* __restrict__ order, float* __restrict__ roi_boxes,
    float* __restrict__ roi_scores, int* __restrict__ num_valid, int N, int pre,
    int max_output, int cap, float iou_threshold) {
  select_image<false>(boxes, scores, order, nullptr, roi_boxes, roi_scores, num_valid, N, pre,
                      max_output, cap, iou_threshold);
}

__global__ void __launch_bounds__(kThreads, 1) proposal_kernel_levels(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    const long long* __restrict__ order, const int* __restrict__ levels,
    float* __restrict__ roi_boxes, float* __restrict__ roi_scores, int* __restrict__ num_valid,
    int N, int pre, int max_output, int cap, float iou_threshold) {
  select_image<true>(boxes, scores, order, levels, roi_boxes, roi_scores, num_valid, N, pre,
                     max_output, cap, iou_threshold);
}

}  // namespace

TPURPN_EXPORT int proposal_select(const float* boxes, const float* scores,
                                  const long long* order, float* roi_boxes,
                                  float* roi_scores, int* num_valid, int B, int N,
                                  int pre, int max_output, float iou_threshold,
                                  cudaStream_t stream) {
  if (B <= 0 || pre <= 0 || pre > N || max_output <= 0) return cudaErrorInvalidValue;
  const int cap = min(max_output, pre);  // kept boxes never exceed either
  const size_t smem = smem_bytes(cap, false);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      proposal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  proposal_kernel<<<B, kThreads, smem, stream>>>(boxes, scores, order, roi_boxes,
                                                 roi_scores, num_valid, N, pre,
                                                 max_output, cap, iou_threshold);
  return cudaGetLastError();
}

// proposal_select with a level id a candidate: levels (N,) int32.
TPURPN_EXPORT int proposal_select_levels(const float* boxes, const float* scores,
                                         const long long* order, const int* levels,
                                         float* roi_boxes, float* roi_scores, int* num_valid,
                                         int B, int N, int pre, int max_output,
                                         float iou_threshold, cudaStream_t stream) {
  if (B <= 0 || pre <= 0 || pre > N || max_output <= 0) return cudaErrorInvalidValue;
  const int cap = min(max_output, pre);
  const size_t smem = smem_bytes(cap, true);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      proposal_kernel_levels, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  proposal_kernel_levels<<<B, kThreads, smem, stream>>>(boxes, scores, order, levels, roi_boxes,
                                                        roi_scores, num_valid, N, pre,
                                                        max_output, cap, iou_threshold);
  return cudaGetLastError();
}

TPURPN_EXPORT const char* proposal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
