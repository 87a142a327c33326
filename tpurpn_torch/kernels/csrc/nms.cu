// Greedy-NMS keep mask over score-sorted boxes for Hopper (sm_90a), one
// thread block of 1,024 threads per image.
//
// Replaces tpurpn/kernels/nms_pallas.py::nms_pallas_keep_planes (body
// _nms_kernel). It computes what that kernel computes: the keep mask and
// kept count of greedy NMS over boxes already in descending score order,
// decided in whole `block`-wide blocks; an image stops only after the block
// in which its count reaches max_output, so the count may overshoot
// max_output (the stop rule of tpurpn.boxes._nms_keep_sorted_batched). The
// TPU kernel's lane planes, its chunked sweep of the keep row and its MXU
// fixpoint matvec exist for Mosaic; `block` is kept as the stop rule's unit
// only.
//
// What bounds it: the chain of decisions. Box j can only be decided once
// every earlier keep is known. Config 4 (B=32, n=2000, max_output 300,
// block 128) decides some 1,400 boxes an image (11-12 blocks;
// chip_smoke.py counts them) with some 10^5 IoU tests: about a microsecond
// of f32 work over the card, and 30 KB read an image. The number of
// dependent steps in that chain, and what each step costs, set the time.
//
// Design: the rounds of proposal.cu. The block stages the current `block`
// boxes, their areas and validity in shared memory, then decides them 32 at
// a time, with two barriers a round:
//   (a) warp w takes candidate w of the chunk. Its lanes test it against the
//       kept boxes 32 at a time and stop at the first hit (kept_suppresses,
//       common.cuh), so a suppressed candidate usually costs a step or two;
//   (b) the same warp builds the candidate's in-chunk row in one ballot
//       (chunk_row): lane j < w votes IoU(w, j) > thr;
//   -- barrier --
//   (c) warp 0 resolves the chunk with chunk_walk, room 32: the stop rule
//       acts only at block ends, never inside a chunk, so every candidate of
//       the block is decided. It appends the keeps to the kept list in order
//       and writes the chunk's 32 keep bytes;
//   -- barrier --
// Overlap is tested before the division (iou_above): disjoint boxes have
// IoU +-0 exactly. At config 4 an image takes some 44 rounds. The kept list
// (cap = min(n, max_output + block - 1) boxes and areas, 20 bytes each)
// lives in shared memory beside the staged block when both fit in 200 KB
// (cap up to about 9,100), else in the caller's global scratch row.
//
// Exactness: the IoU is the plain version's op for op (box_iou, built with
// -fmad=false and IEEE division), symmetric bit for bit, and iou_above
// skips the division only where the answer is exact without it, so the
// keep mask is bit-identical to the plain version's.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;  // also the widest block of the stop rule
constexpr int kChunk = 32;      // candidates decided a round, one a warp
constexpr size_t kSmemLimit = 200 * 1024;
static_assert(kThreads / 32 == kChunk, "one warp a candidate of the chunk");

// the staged block: box, area, validity byte
size_t block_smem_bytes(int block) { return (size_t)block * 21; }

__global__ void __launch_bounds__(kThreads, 1) nms_kernel(
    const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ keep, int* __restrict__ count, float4* kept_box_global,
    float* kept_area_global, int n, int block, int max_output, int cap, float iou_threshold,
    int kept_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_row[kChunk];
  __shared__ int s_hit[kChunk];
  __shared__ int s_kept;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // [kept boxes (cap)] staged boxes (block) [kept areas (cap)] areas, bytes
  unsigned char* p = smem;
  float4* kbox = kept_box_global + (size_t)b * cap;
  float* karea = kept_area_global + (size_t)b * cap;
  if (kept_in_smem) {
    kbox = reinterpret_cast<float4*>(p);
    p += (size_t)cap * 16;
  }
  float4* cbox = reinterpret_cast<float4*>(p);
  p += (size_t)block * 16;
  if (kept_in_smem) {
    karea = reinterpret_cast<float*>(p);
    p += (size_t)cap * 4;
  }
  float* carea = reinterpret_cast<float*>(p);
  uint8_t* cok = reinterpret_cast<uint8_t*>(carea + block);
  const float4* bx = boxes + (size_t)b * n;
  const uint8_t* vd = valid + (size_t)b * n;
  uint8_t* kp = keep + (size_t)b * n;

  int kept = 0;  // uniform over the block
  int start = 0;
  for (; start < n && kept < max_output; start += block) {
    const int nb = min(block, n - start);
    // the previous block is no longer read: the last round ended in a barrier
    if (t < block) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      uint8_t ok = 0;
      if (t < nb) {
        v = bx[start + t];
        ok = vd[start + t] != 0;
      }
      cbox[t] = v;
      carea[t] = box_area(v);
      cok[t] = ok;
    }
    __syncthreads();
    for (int c0 = 0; c0 < nb; c0 += kChunk) {
      const int w = c0 + warp;  // this warp's candidate
      if (w < nb && cok[w]) {
        const float4 v = cbox[w];
        const float a = carea[w];
        const uint32_t row = chunk_row(v, a, cbox + c0, carea + c0, warp, iou_threshold);
        const int hit = kept_suppresses(v, a, kbox, karea, kept, iou_threshold);
        if (lane == 0) {
          s_row[warp] = row;
          s_hit[warp] = hit;
        }
      } else if (lane == 0) {
        s_row[warp] = 0;
        s_hit[warp] = 1;  // invalid or past n: never kept
      }
      __syncthreads();
      if (warp == 0) {  // (c) resolve the chunk in order
        const int i = c0 + lane;
        const uint32_t alive = __ballot_sync(0xffffffffu, !s_hit[lane]);
        const uint32_t keep_bits = chunk_walk(alive, s_row[lane], kChunk);
        const bool mine = (keep_bits >> lane) & 1u;
        if (mine) {
          const int pos = kept + __popc(keep_bits & ((1u << lane) - 1u));
          kbox[pos] = cbox[i];
          karea[pos] = carea[i];
        }
        if (i < nb) kp[start + i] = mine;
        if (lane == 0) s_kept = kept + __popc(keep_bits);
      }
      __syncthreads();  // the appended boxes and the count are visible
      kept = s_kept;
    }
  }
  for (int j = start + t; j < n; j += kThreads) kp[j] = 0;  // never decided
  if (t == 0) count[b] = kept;
}

}  // namespace

TPURPN_EXPORT int nms_keep(const float* boxes, const uint8_t* valid, uint8_t* keep, int* count,
                           float* kept_box, float* kept_area, int B, int n, int max_output,
                           int block, int cap, float iou_threshold, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || block < kChunk || block > kThreads || block % kChunk ||
      cap < 1 || cap < min(n, max_output + block - 1))
    return cudaErrorInvalidValue;
  size_t smem = block_smem_bytes(block);
  const size_t kept_bytes = (size_t)cap * 20;
  const int kept_in_smem = smem + kept_bytes <= kSmemLimit;
  if (kept_in_smem) smem += kept_bytes;
  cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  nms_kernel<<<B, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(boxes), valid, keep, count,
      reinterpret_cast<float4*>(kept_box), kept_area, n, block, max_output, cap, iou_threshold,
      kept_in_smem);
  return cudaGetLastError();
}

TPURPN_EXPORT const char* nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
