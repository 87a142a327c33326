// RPN training targets and IoU matching for Hopper (sm_90a), one thread
// block per image.
//
// Replaces tpurpn/kernels/target_pallas.py: fused_rpn_targets (body
// _targets_kernel, with _iou_matching_phase, _make_key_row and
// _kth_smallest_threshold) and fused_iou_matching (body _matching_kernel).
// It takes what those kernels compute, not their TPU layout: the anchor
// lane planes, the GT sublane columns and the one-hot matched-GT gather exist
// for Mosaic. Here each thread owns the anchors n = t, t + 1024, ... of its
// image for the whole kernel, so per-anchor state needs no barrier between
// the phases.
//
// Phase 1 (IoU matching, shared by both entries): GT boxes are staged in
// shared memory 8 at a time, any M. Each thread computes the IoU of its
// anchors against the 8 boxes, keeping the per-anchor running max and first
// argmax GT (strict > in GT order: the first maximum, as jnp.argmax), and a
// per-GT (max, lowest anchor index) pair in registers, which a warp shuffle
// and a shared-memory pass reduce over the block.
//
// Phase 2 (selection): positives are IoU > pos_threshold or the best anchor
// of a valid GT; negatives IoU < neg_threshold and not selected positive.
// Each candidate gets its unique 28-bit key (top random bits of its word
// above the anchor index); the k-th smallest key is found by the same
// 29-round counting binary search as _kth_smallest_threshold, each round one
// block-wide count. Keys live in a global scratch row (B, 2, N), L1-resident
// at these sizes. Then labels 1/0/-1 and the matched-GT deltas, encoded as
// tpurpn.boxes.get_deltas_from_bboxes and divided by the variances.
//
// What bounds it: config 3 (B=8, N=8,649, M=8) is 0.55 M IoU tests and
// about 0.5 MB of words, anchors and outputs; both take under a microsecond
// of the card. The kernel is latency-bound instead: 8 blocks on 132 SMs, and
// 58 dependent block-wide counts (2 x 29 rounds, each a barrier). Speeding
// it up (a radix select, more blocks per image) is later work.
//
// Exactness: the IoU and the deltas are computed op for op as the plain
// version (-fmad=false, IEEE division), so the matching and the labels are
// bit-identical; logf may differ from torch's log by an ulp in delta rows
// 2-3.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kGtChunk = 8;
constexpr int kKeySentinel = 1 << 29;  // above any real key (< 2**28)

// Sum of v over the block. `red` is 2 x kWarps ints used in turns, so one
// barrier a call suffices: a thread writes a buffer again only after every
// thread has passed the barrier of the call between, and with it the reads.
__device__ __forceinline__ int block_sum(int v, int* red, int& parity) {
  v = __reduce_add_sync(0xffffffffu, v);
  int* r = red + parity * kWarps;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += r[w];
  return s;
}

// (v, i) beats (ov, oi) when larger, or equal with a lower index.
__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Phase 1 for one image: merged / best_gt per anchor, best_anchor per GT.
__device__ void iou_phase(const float4* __restrict__ anchors, const float4* __restrict__ gt,
                          int N, int M, float* merged, int* best_gt, int* best_anchor) {
  __shared__ float4 s_gt[kGtChunk];
  __shared__ float s_garea[kGtChunk];
  __shared__ float s_v[kWarps][kGtChunk];
  __shared__ int s_i[kWarps][kGtChunk];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (int c0 = 0; c0 < M; c0 += kGtChunk) {
    const int gn = min(kGtChunk, M - c0);
    __syncthreads();  // the previous chunk's shared boxes and partials are read
    if (t < gn) {
      const float4 g = gt[c0 + t];
      s_gt[t] = g;
      s_garea[t] = box_area(g);
    }
    __syncthreads();
    float cmax[kGtChunk];
    int carg[kGtChunk];
#pragma unroll
    for (int g = 0; g < kGtChunk; ++g) {
      cmax[g] = -1.0f;
      carg[g] = 0;
    }
    for (int n = t; n < N; n += kThreads) {
      const float4 a = anchors[n];
      const float a_area = box_area(a);
      float m = c0 == 0 ? -1.0f : merged[n];
      int bi = c0 == 0 ? 0 : best_gt[n];
#pragma unroll
      for (int g = 0; g < kGtChunk; ++g) {
        if (g < gn) {
          const float iou = box_iou(s_gt[g], s_garea[g], a, a_area);
          if (iou > m) {
            m = iou;
            bi = c0 + g;
          }
          if (iou > cmax[g]) {  // anchors ascend: strict > keeps the first
            cmax[g] = iou;
            carg[g] = n;
          }
        }
      }
      merged[n] = m;
      best_gt[n] = bi;
    }
#pragma unroll
    for (int g = 0; g < kGtChunk; ++g) {
      float v = cmax[g];
      int i = carg[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        take_max(v, i, __shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off));
      if (lane == 0) {
        s_v[warp][g] = v;
        s_i[warp][g] = i;
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int g = 0; g < gn; ++g) {
        float v = s_v[lane][g];
        int i = s_i[lane][g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          take_max(v, i, __shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off));
        if (lane == 0) best_anchor[c0 + g] = i;
      }
    }
  }
  __syncthreads();  // best_anchor is visible to the whole block
}

__device__ __forceinline__ int selection_key(int word, int n, int lane_bits) {
  const uint32_t rand_bits = 28 - lane_bits;
  return (int)(((uint32_t)word >> (32 - rand_bits)) << lane_bits) | n;
}

// The k-th smallest key of keys[0, N) (unique keys, k <= candidates), or -1
// for k <= 0: the smallest T with count(keys <= T) >= k, by the 29-round
// binary search of _kth_smallest_threshold.
__device__ int kth_smallest_key(const int* keys, int N, int k, int* red, int& parity) {
  if (k <= 0) return -1;  // k is uniform over the block
  int lo = 0, hi = 1 << 28;
  for (int round = 0; round < 29; ++round) {
    const int mid = (lo + hi) >> 1;
    int c = 0;
    for (int n = threadIdx.x; n < N; n += kThreads) c += keys[n] <= mid;
    if (block_sum(c, red, parity) >= k)
      hi = mid;
    else
      lo = mid + 1;
  }
  return hi;
}

__global__ void __launch_bounds__(kThreads) matching_kernel(
    const float4* __restrict__ anchors, const float4* __restrict__ gt_boxes,
    float* __restrict__ merged, int* __restrict__ best_gt, int* __restrict__ best_anchor,
    int N, int M) {
  const int b = blockIdx.x;
  iou_phase(anchors, gt_boxes + (size_t)b * M, N, M, merged + (size_t)b * N,
            best_gt + (size_t)b * N, best_anchor + (size_t)b * M);
}

struct TargetParams {
  int lane_bits;
  float pos_threshold, neg_threshold;
  int total_pos, total_minibatch;
  float var[4];
};

__global__ void __launch_bounds__(kThreads) targets_kernel(
    const float4* __restrict__ anchors, const float4* __restrict__ gt_boxes,
    const int* __restrict__ gt_valid, const int* __restrict__ rand_words,
    float4* __restrict__ deltas, float* __restrict__ labels, float* merged_all,
    int* best_gt_all, int* best_anchor_all, int* keys_all, int N, int M, TargetParams p) {
  __shared__ int red[2 * kWarps];
  const int b = blockIdx.x, t = threadIdx.x;
  const float4* gt = gt_boxes + (size_t)b * M;
  float* merged = merged_all + (size_t)b * N;
  int* best_gt = best_gt_all + (size_t)b * N;
  int* best_anchor = best_anchor_all + (size_t)b * M;
  iou_phase(anchors, gt, N, M, merged, best_gt, best_anchor);

  const int* w_pos = rand_words + (size_t)b * 2 * N;
  const int* w_neg = w_pos + N;
  int* pos_keys = keys_all + (size_t)b * 2 * N;
  int* neg_keys = pos_keys + N;
  int parity = 0;

  // positive candidates: above the threshold, then the forced best anchor
  // of every valid GT (several GTs may force one anchor: same value written)
  for (int n = t; n < N; n += kThreads)
    pos_keys[n] = merged[n] > p.pos_threshold ? selection_key(w_pos[n], n, p.lane_bits)
                                              : kKeySentinel;
  __syncthreads();
  for (int m = t; m < M; m += kThreads) {
    if (gt_valid[(size_t)b * M + m]) {
      const int a = best_anchor[m];
      pos_keys[a] = selection_key(w_pos[a], a, p.lane_bits);
    }
  }
  __syncthreads();
  int c = 0;
  for (int n = t; n < N; n += kThreads) c += pos_keys[n] != kKeySentinel;
  const int avail_pos = block_sum(c, red, parity);
  const int t_pos = kth_smallest_key(pos_keys, N, min(p.total_pos, avail_pos), red, parity);

  // negative candidates: below the threshold and not selected positive
  c = 0;
  int c_neg = 0;
  for (int n = t; n < N; n += kThreads) {
    const bool pos = pos_keys[n] <= t_pos;
    const bool cand = !pos && merged[n] < p.neg_threshold;
    c += pos;
    c_neg += cand;
    neg_keys[n] = cand ? selection_key(w_neg[n], n, p.lane_bits) : kKeySentinel;
  }
  const int pos_count = block_sum(c, red, parity);
  const int avail_neg = block_sum(c_neg, red, parity);  // also orders neg_keys' writes
  const int t_neg =
      kth_smallest_key(neg_keys, N, min(p.total_minibatch - pos_count, avail_neg), red, parity);

  for (int n = t; n < N; n += kThreads) {
    const bool pos = pos_keys[n] <= t_pos;
    const bool neg = neg_keys[n] <= t_neg;
    labels[(size_t)b * N + n] = pos ? 1.0f : (neg ? 0.0f : -1.0f);
    const float4 a = anchors[n];
    const float4 g = pos ? gt[best_gt[n]] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // get_deltas_from_bboxes: centres from the raw sizes, then the guards
    const float a_h0 = a.z - a.x, a_w0 = a.w - a.y;
    const float a_cy = a.x + 0.5f * a_h0, a_cx = a.y + 0.5f * a_w0;
    const float g_h = g.z - g.x, g_w = g.w - g.y;
    const float g_cy = g.x + 0.5f * g_h, g_cx = g.y + 0.5f * g_w;
    const float a_h = a_h0 == 0.0f ? 1e-3f : a_h0;
    const float a_w = a_w0 == 0.0f ? 1e-3f : a_w0;
    const float g_h_safe = g_h <= 0.0f ? 1.0f : g_h;
    const float g_w_safe = g_w <= 0.0f ? 1.0f : g_w;
    float4 d;
    d.x = (g_h == 0.0f ? 0.0f : (g_cy - a_cy) / a_h) / p.var[0];
    d.y = (g_w == 0.0f ? 0.0f : (g_cx - a_cx) / a_w) / p.var[1];
    d.z = (g_h == 0.0f ? 0.0f : logf(g_h_safe / a_h)) / p.var[2];
    d.w = (g_w == 0.0f ? 0.0f : logf(g_w_safe / a_w)) / p.var[3];
    deltas[(size_t)b * N + n] = d;
  }
}

}  // namespace

TPURPN_EXPORT int iou_matching(const float* anchors, const float* gt_boxes, float* merged,
                               int* best_gt, int* best_anchor, int B, int N, int M,
                               cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  matching_kernel<<<B, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(anchors), reinterpret_cast<const float4*>(gt_boxes),
      merged, best_gt, best_anchor, N, M);
  return cudaGetLastError();
}

TPURPN_EXPORT int rpn_targets(const float* anchors, const float* gt_boxes, const int* gt_valid,
                              const int* rand_words, float* deltas, float* labels,
                              float* merged, int* best_gt, int* best_anchor, int* keys, int B,
                              int N, int M, int lane_bits, float pos_threshold,
                              float neg_threshold, int total_pos, int total_minibatch,
                              float var0, float var1, float var2, float var3,
                              cudaStream_t stream) {
  if (B <= 0 || N <= 0 || M <= 0 || lane_bits < 14 || lane_bits > 20 || N > (1 << lane_bits))
    return cudaErrorInvalidValue;
  TargetParams p{lane_bits, pos_threshold, neg_threshold, total_pos, total_minibatch,
                 {var0, var1, var2, var3}};
  targets_kernel<<<B, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(anchors), reinterpret_cast<const float4*>(gt_boxes),
      gt_valid, rand_words, reinterpret_cast<float4*>(deltas), labels, merged, best_gt,
      best_anchor, keys, N, M, p);
  return cudaGetLastError();
}

TPURPN_EXPORT const char* targets_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
