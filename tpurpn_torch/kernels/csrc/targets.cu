// RPN training targets and IoU matching for Hopper (sm_90a): one thread-
// block cluster per image for the matching, its rank 0 for the selection.
//
// Replaces tpurpn/kernels/target_pallas.py: fused_rpn_targets (body
// _targets_kernel, with _iou_matching_phase, _make_key_row and
// _kth_smallest_threshold) and fused_iou_matching (body _matching_kernel).
// It takes what those kernels compute, not their TPU layout: the anchor
// lane planes, the GT sublane columns and the one-hot matched-GT gather exist
// for Mosaic.
//
// Phase 1 (IoU matching, shared by both entries, as the TPU kernels share
// _iou_matching_phase): merged[n] = max_m IoU(n, m) and best_gt[n] its first
// m; best_anchor[m] = the lowest n reaching max_n IoU(n, m).
//
// What bounds it: config 3 (B=8, N=8,649, M=8) is 0.55 M IoU tests (69 k
// an image), about 0.1 us of f32 work over the whole card, and 0.7 MB of
// anchors and outputs: a job of a few microseconds at best, so latency
// sets its time. One block an image (the design before this one) left 124
// of 132 SMs idle and chained, on one SM, each image's 69 k divisions, a
// read-modify-write of merged / best_gt and three block barriers for every
// 8 GTs.
//
// Design: the grid is (C, B), one cluster of C blocks an image (C = 8 or
// 16, chosen once a device by an occupancy query, choose_cluster below).
// Block r owns the anchors [r*S, min((r+1)*S, N)), S = ceil(N / C); thread
// t takes anchors t and t + 1,024 of each pass of 2,048 (one pass up to S
// = 2,048), loaded before the block's first barrier. The block stages 256
// GT boxes and their areas in shared memory at a time (any M: one chunk up
// to 256 GTs). A thread takes its anchors against every GT of the chunk,
// keeps the per-anchor running max and first argmax in registers (strict >
// in GT order: the first maximum, as jnp.argmax) and writes merged /
// best_gt once. The division is skipped where the boxes do not overlap
// (match_iou). The per-GT (IoU, anchor) pairs of 8 GTs at a time meet in a
// transposed warp butterfly (warp_reduce8: 9 exchanges, not 8 x 5), and
// lane 4g's pair enters the block's shared 64-bit key of GT g by
// atomicMax. After a cluster barrier, rank r reduces the GTs j = r (mod
// C): a thread reads one rank's key of one GT through distributed shared
// memory, a shuffle takes the max over the C ranks, and the best anchor is
// written. A second cluster barrier keeps every block (and its shared
// keys) alive until the last remote read. One launch a call, no global
// counter. On the card (PERF.md) the IoU loop is most of a block's time,
// and the division most of the loop, more than the two cluster barriers
// and the remote reads.
//
// Exactness of the matching: box_iou is the plain version's op for op
// (-fmad=false, IEEE division). A (IoU, index) pair is keyed as the IoU's
// bits above the complemented index, so the larger key is the larger IoU,
// then the lower anchor index, across slice boundaries too; the IoU is >= 0
// and can be -0 (common.cuh), so zero is keyed as +0 first: floats compare
// as floats. A pair of an empty slice (N < C, or the last slice) is key 0,
// below every real pair, as (-1, INT_MAX) is; such a block still reaches
// both cluster barriers, and no block returns before the last one.
//
// Phase 2 (selection, rank 0 of the target entry's cluster, over the whole
// image, after the cluster barrier whose release / acquire orders the other
// ranks' global writes): positives are IoU > pos_threshold or the best
// anchor of a valid GT; negatives IoU < neg_threshold and not selected
// positive. Each candidate gets its unique 28-bit key (top random bits of
// its word above the anchor index); the others hold the sentinel 2**29. The
// k candidates with the smallest keys are kept. Then labels 1/0/-1 and the
// matched-GT deltas, encoded as tpurpn.boxes.get_deltas_from_bboxes and
// divided by the variances. The TPU kernel finds each threshold by a
// 29-round counting binary search (_kth_smallest_threshold); here it is a
// radix select of 4 passes of 7 bits (radix_select). A pass builds a
// 128-bin histogram in shared memory (shared atomics) of the digit among
// the keys whose higher digits equal the prefix found so far; then one warp
// scans the bins (4 a lane, a shuffle scan) and takes the digit where the
// running count reaches the rank sought. Two barriers a pass: the bins are
// double-buffered, and the scanning warp clears the other buffer. Since the
// keys are unique, this is exactly the binary search's threshold; the first
// pass's histogram total is the number of candidates (the sentinel has a
// nonzero top digit and is never counted), and the positives selected
// number exactly k. Both key rows of an image (8 bytes an anchor) live in
// shared memory up to N = 25,600 (200 KB; every block of the launch gets
// it), else in the global scratch row (B, 2, N). Only the positives (at
// most total_pos) take the full delta encoding, the rest write the zero
// box's encoding.
//
// Exactness of the targets: the deltas are computed op for op as the plain
// version, so the labels are bit-identical; logf may differ from torch's
// log by an ulp in delta rows 2-3.

#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kGtChunk = 256;  // GT boxes staged in shared memory at a time
constexpr int kPerThread = 2;  // anchors a thread takes in a pass of the matching
constexpr int kPass = kThreads * kPerThread;
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

// (v, i) <- take_max(keep, the partner's send) across lanes `off` apart.
__device__ __forceinline__ void exchange(float& v, int& i, float keep_v, int keep_i,
                                         float send_v, int send_i, int off) {
  const float ov = __shfl_xor_sync(0xffffffffu, send_v, off);
  const int oi = __shfl_xor_sync(0xffffffffu, send_i, off);
  v = keep_v;
  i = keep_i;
  take_max(v, i, ov, oi);
}

// The pairs (v[g], i[g]) of 8 GTs over a warp, reduced by take_max in a
// transposed butterfly: at offsets 16, 8 and 4 a lane keeps half of the GTs
// it holds and sends the other half to its partner, which keeps those; then
// offsets 2 and 1 reduce the one GT left. Lane l ends with GT l >> 2's pair
// over all 32 lanes. take_max is associative and commutative, so the order
// does not change the result.
__device__ __forceinline__ void warp_reduce8(float (&v)[8], int (&i)[8], float& rv, int& ri) {
  const int lane = threadIdx.x & 31;
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    exchange(v[j], i[j], h16 ? v[j + 4] : v[j], h16 ? i[j + 4] : i[j], h16 ? v[j] : v[j + 4],
             h16 ? i[j] : i[j + 4], 16);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    exchange(v[j], i[j], h8 ? v[j + 2] : v[j], h8 ? i[j + 2] : i[j], h8 ? v[j] : v[j + 2],
             h8 ? i[j] : i[j + 2], 8);
  exchange(v[0], i[0], h4 ? v[1] : v[0], h4 ? i[1] : i[0], h4 ? v[0] : v[1], h4 ? i[0] : i[1], 4);
  rv = v[0];
  ri = i[0];
#pragma unroll
  for (int off = 2; off > 0; off >>= 1)
    take_max(rv, ri, __shfl_xor_sync(0xffffffffu, rv, off), __shfl_xor_sync(0xffffffffu, ri, off));
}

// A pair (v >= 0, i >= 0) as one key whose unsigned order is take_max's:
// the IoU's bits (nonnegative floats order as their bits; -0 keyed as +0)
// above the complemented index.
__device__ __forceinline__ unsigned long long pair_key(float v, int i) {
  const uint32_t bits = v == 0.0f ? 0u : __float_as_uint(v);
  return ((unsigned long long)bits << 32) | (uint32_t)~i;
}

// box_iou, without the division where the boxes do not overlap: there the
// intersection is +-0 and box_iou returns it as it is (its denominator is at
// least 1e-8), so the IoU is box_iou's bit for bit. Most anchor-GT pairs do
// not overlap, and the division is the largest part of a test.
__device__ __forceinline__ float match_iou(float4 g, float g_area, float4 a, float a_area) {
  const float ih = fmaxf(fminf(g.z, a.z) - fmaxf(g.x, a.x), 0.0f);
  const float iw = fmaxf(fminf(g.w, a.w) - fmaxf(g.y, a.y), 0.0f);
  if (ih * iw == 0.0f) return ih * iw;
  return box_iou(g, g_area, a, a_area);
}

// Phase 1 for image b (this cluster): merged / best_gt per anchor of this
// block's slice, best_anchor per GT from rank r for the GTs j = r (mod C).
// Ends with a cluster barrier: every rank's writes are visible to all.
__device__ void iou_phase(const float4* __restrict__ anchors, const float4* __restrict__ gt,
                          int N, int M, float* merged, int* best_gt, int* best_anchor) {
  __shared__ float4 s_gt[kGtChunk];
  __shared__ float s_garea[kGtChunk];
  __shared__ unsigned long long s_key[kGtChunk];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks(), r = cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31;
  const int S = (N + C - 1) / C;
  const int lo = min(r * S, N), hi = min(lo + S, N);

  for (int c0 = 0; c0 < M; c0 += kGtChunk) {
    const int gn = min(kGtChunk, M - c0);
    // the first pass's anchors are loaded before the staging barrier
    float4 a[kPerThread];
    auto load_pass = [&](int base) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int n = base + t + k * kThreads;
        a[k] = n < hi ? anchors[n] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    };
    load_pass(lo);
    for (int g = t; g < gn; g += kThreads) {
      const float4 box = gt[c0 + g];
      s_gt[g] = box;
      s_garea[g] = box_area(box);
      s_key[g] = 0;  // (-1, INT_MAX): below every real pair
    }
    __syncthreads();
    // the warp's anchors lie past the slice from this pass on (warp-uniform)
    for (int base = lo; base + (t & ~31) < hi; base += kPass) {
      if (base != lo) load_pass(base);
      float a_area[kPerThread], m[kPerThread];
      int bi[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int n = base + t + k * kThreads;
        a_area[k] = box_area(a[k]);
        m[k] = -1.0f;  // carried through the global row past the first chunk
        bi[k] = 0;
        if (n < hi && c0 > 0) {
          m[k] = merged[n];
          bi[k] = best_gt[n];
        }
      }
      for (int g0 = 0; g0 < gn; g0 += 8) {
        float cv[8];
        int ci[8];
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          cv[g] = -1.0f;
          ci[g] = INT_MAX;
        }
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {  // the thread's anchors ascend
          const int n = base + t + k * kThreads;
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            if (n < hi && g0 + g < gn) {
              const float iou = match_iou(s_gt[g0 + g], s_garea[g0 + g], a[k], a_area[k]);
              if (iou > m[k]) {
                m[k] = iou;
                bi[k] = c0 + g0 + g;
              }
              if (iou > cv[g]) {
                cv[g] = iou;
                ci[g] = n;
              }
            }
          }
        }
        float v;
        int i;
        warp_reduce8(cv, ci, v, i);
        if ((lane & 3) == 0 && v >= 0.0f) atomicMax(&s_key[g0 + (lane >> 2)], pair_key(v, i));
      }
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int n = base + t + k * kThreads;
        if (n < hi) {
          merged[n] = m[k];
          best_gt[n] = bi[k];
        }
      }
    }
    cluster.sync();  // every block's keys of this chunk are final
    {
      // thread t reads rank q's key of GT j; C divides 32, so a group of C
      // lanes holds one GT's C keys
      const int q = t & (C - 1), j = r + t - q;
      unsigned long long key = 0;
      if (j < gn) key = *cluster.map_shared_rank(&s_key[j], q);
      for (int off = C >> 1; off > 0; off >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
        key = other > key ? other : key;
      }
      if (q == 0 && j < gn) best_anchor[c0 + j] = (int)~(uint32_t)key;
    }
    cluster.sync();  // no block overwrites or frees its keys while another reads them
  }
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

__global__ void __launch_bounds__(kThreads, 1) matching_kernel(
    const float4* __restrict__ anchors, const float4* __restrict__ gt_boxes,
    float* __restrict__ merged, int* __restrict__ best_gt, int* __restrict__ best_anchor,
    int N, int M) {
  const int b = blockIdx.y;
  iou_phase(anchors, gt_boxes + (size_t)b * M, N, M, merged + (size_t)b * N,
            best_gt + (size_t)b * N, best_anchor + (size_t)b * M);
}

struct TargetParams {
  int lane_bits;
  float pos_threshold, neg_threshold;
  int total_pos, total_minibatch;
  float var[4];
};

__global__ void __launch_bounds__(kThreads, 1) targets_kernel(
    const float4* __restrict__ anchors, const float4* __restrict__ gt_boxes,
    const int* __restrict__ gt_labels, const int* __restrict__ rand_words,
    float4* __restrict__ deltas, float* __restrict__ labels, float* merged_all,
    int* best_gt_all, int* best_anchor_all, int* keys_all, int N, int M, int keys_in_smem,
    TargetParams p) {
  extern __shared__ int s_keys[];  // both key rows, when keys_in_smem
  __shared__ __align__(16) RadixScratch radix;
  const int b = blockIdx.y, t = threadIdx.x;
  if (t < 2 * kBins) (&radix.bins[0][0])[t] = 0;  // before iou_phase's barriers
  const float4* gt = gt_boxes + (size_t)b * M;
  float* merged = merged_all + (size_t)b * N;
  int* best_gt = best_gt_all + (size_t)b * N;
  int* best_anchor = best_anchor_all + (size_t)b * M;
  iou_phase(anchors, gt, N, M, merged, best_gt, best_anchor);
  if (cg::this_cluster().block_rank() != 0) return;  // past the last cluster barrier

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

enum Entry { kMatching = 0, kTargets = 1 };
constexpr int kMaxDevices = 64;
int g_cluster[2][kMaxDevices];  // chosen cluster size per entry and device, 0 = not yet

const void* entry_kernel(int entry) {
  return entry == kMatching ? reinterpret_cast<const void*>(matching_kernel)
                            : reinterpret_cast<const void*>(targets_kernel);
}

// Grid (C, B), clusters of (C, 1, 1), on `stream`.
cudaLaunchConfig_t cluster_config(int c, int B, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size of an entry on the current device: of 16 and 8, the one
// that keeps the most blocks resident (max active clusters x C, from the
// occupancy query at 1,024 threads and the entry's largest dynamic shared
// memory), the larger on a tie. Chosen at the first call on a device (which
// also sets the kernel's shared-memory and cluster attributes) and kept.
// Returns C, or minus the CUDA error when no cluster size schedules.
int choose_cluster(int entry) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  if (g_cluster[entry][dev]) return g_cluster[entry][dev];
  const void* fn = entry_kernel(entry);
  const int smem = entry == kTargets ? (int)kKeySmemLimit : 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  const int sizes[] = {16, 8};
  int best = 0, best_blocks = 0;
  for (int c : sizes) {
    cudaLaunchAttribute attr = {};
    const cudaLaunchConfig_t cfg = cluster_config(c, 1, smem, nullptr, &attr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg) != cudaSuccess) {
      cudaGetLastError();  // this size does not schedule: not an error of the launch
      continue;
    }
    if (clusters * c > best_blocks) {
      best = c;
      best_blocks = clusters * c;
    }
  }
  if (!best) return -(int)cudaErrorLaunchOutOfResources;
  g_cluster[entry][dev] = best;
  return best;
}

}  // namespace

TPURPN_EXPORT int targets_cluster_size(int entry) {
  if (entry != kMatching && entry != kTargets) return -(int)cudaErrorInvalidValue;
  return choose_cluster(entry);
}

TPURPN_EXPORT int iou_matching(const float* anchors, const float* gt_boxes, float* merged,
                               int* best_gt, int* best_anchor, int B, int N, int M,
                               cudaStream_t stream) {
  if (B <= 0 || B > 65535 || N <= 0 || M <= 0) return cudaErrorInvalidValue;
  const int c = choose_cluster(kMatching);
  if (c < 0) return -c;
  cudaLaunchAttribute attr = {};
  const cudaLaunchConfig_t cfg = cluster_config(c, B, 0, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, matching_kernel, reinterpret_cast<const float4*>(anchors),
      reinterpret_cast<const float4*>(gt_boxes), merged, best_gt, best_anchor, N, M);
  return err != cudaSuccess ? err : cudaGetLastError();
}

TPURPN_EXPORT int rpn_targets(const float* anchors, const float* gt_boxes, const int* gt_labels,
                              const int* rand_words, float* deltas, float* labels,
                              float* merged, int* best_gt, int* best_anchor, int* keys, int B,
                              int N, int M, int lane_bits, float pos_threshold,
                              float neg_threshold, int total_pos, int total_minibatch,
                              float var0, float var1, float var2, float var3,
                              cudaStream_t stream) {
  if (B <= 0 || B > 65535 || N <= 0 || M <= 0 || lane_bits < 14 || lane_bits > 20 ||
      N > (1 << lane_bits))
    return cudaErrorInvalidValue;
  const int c = choose_cluster(kTargets);
  if (c < 0) return -c;
  TargetParams p{lane_bits, pos_threshold, neg_threshold, total_pos, total_minibatch,
                 {var0, var1, var2, var3}};
  const size_t key_bytes = (size_t)N * 2 * sizeof(int);
  const int keys_in_smem = key_bytes <= kKeySmemLimit;
  cudaLaunchAttribute attr = {};
  const cudaLaunchConfig_t cfg =
      cluster_config(c, B, keys_in_smem ? key_bytes : 0, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, targets_kernel, reinterpret_cast<const float4*>(anchors),
      reinterpret_cast<const float4*>(gt_boxes), gt_labels, rand_words,
      reinterpret_cast<float4*>(deltas), labels, merged, best_gt, best_anchor, keys, N, M,
      keys_in_smem, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

TPURPN_EXPORT const char* targets_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
