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
// above the anchor index); the others hold the sentinel 2**29. The k
// candidates with the smallest keys are kept. Then labels 1/0/-1 and the
// matched-GT deltas, encoded as tpurpn.boxes.get_deltas_from_bboxes and
// divided by the variances.
//
// What bounds it: config 3 (B=8, N=8,649, M=8) is 0.55 M IoU tests and
// about 2 MB of words, anchors and outputs; both take under a microsecond
// of the card. The kernel is latency-bound instead: 8 blocks on 132 SMs,
// and a chain of dependent block-wide steps, each behind a barrier. The TPU
// kernel finds each threshold by a 29-round counting binary search
// (_kth_smallest_threshold), 58 block-wide counts for the two selections.
//
// Design: the k-th smallest key is found by a radix select of 4 passes of 7
// bits (radix_select). A pass builds a 128-bin histogram in shared memory
// (shared atomics) of the digit among the keys whose higher digits equal
// the prefix found so far; then one warp scans the bins (4 a lane, a
// shuffle scan) and takes the digit where the running count reaches the
// rank sought. Two barriers a pass: the bins are double-buffered, and the
// scanning warp clears the other buffer. Since the keys are unique, this
// is exactly the binary search's threshold; the first pass's histogram
// total is the number of candidates (the sentinel has a nonzero top digit
// and is never counted), and the positives selected number exactly k, so
// no other block-wide count is needed. Both key rows of an image (8 bytes
// an anchor) live in shared memory up to N = 25,600 (200 KB), else in the
// global scratch row (B, 2, N). One read of the matching results builds
// both key rows; a selected positive leaves the negative row afterwards.
// Each image's work runs on one SM, so its instruction count matters: only
// the positives (at most total_pos) take the full delta encoding, the rest
// write the zero box's encoding. What is left is mostly Phase 1, which the
// matching entry shares (PERF.md).
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
constexpr int kRadixBits = 7;          // 4 passes over the 28-bit keys
constexpr int kBins = 1 << kRadixBits;
constexpr size_t kKeySmemLimit = 200 * 1024;  // both key rows of an image

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

// Shared state of radix_select: two buffers of bins, used in turns, and
// the scanning warp's answer.
struct RadixScratch {
  int bins[2][kBins];
  int prefix, rank, k;
};

// The k-th smallest key of keys[0, N), k = min(budget, number of real keys
// < 2**28): the smallest T with count(keys <= T) >= k, as the binary search
// of _kth_smallest_threshold finds it; -1 for k = 0. Sets k (uniform over
// the block). Four passes of 7 bits, most significant first; `parity`
// names the bins buffer to fill next, which is zero on entry, and every
// scan clears the other one, so a pass has two barriers.
__device__ int radix_select(const int* keys, int N, int budget, int& k, RadixScratch& s,
                            int& parity) {
  k = 0;
  if (budget <= 0) return -1;  // budget is uniform over the block
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0;
  int rank = budget;  // the rank sought among the keys under this prefix
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 28 - kRadixBits * (pass + 1);
    int* bins = s.bins[parity];
    // the digit of the keys under the prefix; in pass 0 the prefix is 0,
    // which the sentinel's top bits never equal
#pragma unroll 4
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const uint32_t key = keys[n];
      if ((key >> (shift + kRadixBits)) == prefix)
        atomicAdd(&bins[(key >> shift) & (kBins - 1)], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // one warp scans the bins, 4 a lane
      const int4 c = reinterpret_cast<const int4*>(bins)[lane];
      reinterpret_cast<int4*>(s.bins[parity ^ 1])[lane] = make_int4(0, 0, 0, 0);
      const int sum = c.x + c.y + c.z + c.w;
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (pass == 0) {
        rank = min(rank, __shfl_sync(0xffffffffu, incl, 31));  // the real keys
        if (lane == 0) s.k = rank;
      }
      const int excl = incl - sum;
      if (excl < rank && rank <= incl) {  // this lane's bins hold the rank
        int d = 4 * lane, below = excl;
        if (below + c.x < rank) {
          below += c.x, ++d;
          if (below + c.y < rank) {
            below += c.y, ++d;
            if (below + c.z < rank) below += c.z, ++d;
          }
        }
        s.prefix = (int)((prefix << kRadixBits) | d);
        s.rank = rank - below;
      }
    }
    __syncthreads();
    parity ^= 1;
    if (pass == 0) {
      k = s.k;
      if (k == 0) return -1;
    }
    prefix = s.prefix;
    rank = s.rank;
  }
  return (int)prefix;
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
    const int* __restrict__ gt_labels, const int* __restrict__ rand_words,
    float4* __restrict__ deltas, float* __restrict__ labels, float* merged_all,
    int* best_gt_all, int* best_anchor_all, int* keys_all, int N, int M, int keys_in_smem,
    TargetParams p) {
  extern __shared__ int s_keys[];  // both key rows, when keys_in_smem
  __shared__ __align__(16) RadixScratch radix;
  const int b = blockIdx.x, t = threadIdx.x;
  if (t < 2 * kBins) (&radix.bins[0][0])[t] = 0;  // before iou_phase's barriers
  const float4* gt = gt_boxes + (size_t)b * M;
  float* merged = merged_all + (size_t)b * N;
  int* best_gt = best_gt_all + (size_t)b * N;
  int* best_anchor = best_anchor_all + (size_t)b * M;
  iou_phase(anchors, gt, N, M, merged, best_gt, best_anchor);

  const int* w_pos = rand_words + (size_t)b * 2 * N;
  const int* w_neg = w_pos + N;
  int* pos_keys = keys_in_smem ? s_keys : keys_all + (size_t)b * 2 * N;
  int* neg_keys = pos_keys + N;
  int parity = 0;

  // positive candidates above the threshold and negative candidates below
  // it, one read of the matching results; then the forced best anchor of
  // every valid GT (several GTs may force one anchor: same value written)
#pragma unroll 4
  for (int n = t; n < N; n += kThreads) {
    const float m = merged[n];
    pos_keys[n] = m > p.pos_threshold ? selection_key(w_pos[n], n, p.lane_bits) : kKeySentinel;
    neg_keys[n] = m < p.neg_threshold ? selection_key(w_neg[n], n, p.lane_bits) : kKeySentinel;
  }
  __syncthreads();
  for (int m = t; m < M; m += kThreads) {
    if (gt_labels[(size_t)b * M + m] != -1) {
      const int a = best_anchor[m];
      pos_keys[a] = selection_key(w_pos[a], a, p.lane_bits);
    }
  }
  __syncthreads();
  int k_pos, k_neg;
  const int t_pos = radix_select(pos_keys, N, p.total_pos, k_pos, radix, parity);

  // a selected positive is no negative candidate (a forced anchor may be
  // below the negative threshold). The keys are unique, so exactly k_pos
  // positives are selected. Each thread changes and then counts only its
  // own anchors' keys: no barrier between.
  for (int n = t; n < N; n += kThreads)
    if (pos_keys[n] <= t_pos) neg_keys[n] = kKeySentinel;
  const int t_neg =
      radix_select(neg_keys, N, p.total_minibatch - k_pos, k_neg, radix, parity);

  // an anchor without a matched GT encodes the zero box: 0 / variance in
  // every row (get_deltas_from_bboxes gives 0 where the GT height or width
  // is 0); only the positives take the full encoding
  const float4 zero = make_float4(0.0f / p.var[0], 0.0f / p.var[1], 0.0f / p.var[2],
                                  0.0f / p.var[3]);
#pragma unroll 4
  for (int n = t; n < N; n += kThreads) {
    const bool pos = pos_keys[n] <= t_pos;
    const bool neg = neg_keys[n] <= t_neg;
    labels[(size_t)b * N + n] = pos ? 1.0f : (neg ? 0.0f : -1.0f);
    if (!pos) {
      deltas[(size_t)b * N + n] = zero;
      continue;
    }
    const float4 a = anchors[n];
    const float4 g = gt[best_gt[n]];
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

TPURPN_EXPORT int rpn_targets(const float* anchors, const float* gt_boxes, const int* gt_labels,
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
  const size_t key_bytes = (size_t)N * 2 * sizeof(int);
  const int keys_in_smem = key_bytes <= kKeySmemLimit;
  const size_t smem = keys_in_smem ? key_bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      targets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  targets_kernel<<<B, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(anchors), reinterpret_cast<const float4*>(gt_boxes),
      gt_labels, rand_words, reinterpret_cast<float4*>(deltas), labels, merged, best_gt,
      best_anchor, keys, N, M, keys_in_smem, p);
  return cudaGetLastError();
}

TPURPN_EXPORT const char* targets_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
