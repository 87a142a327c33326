// Greedy-NMS keep mask over score-sorted boxes for Hopper (sm_90a), one
// thread block per image.
//
// Replaces tpurpn/kernels/nms_pallas.py::nms_pallas_keep_planes (body
// _nms_kernel). It computes what that kernel computes: the keep mask and
// kept count of greedy NMS over boxes already in descending score order,
// decided in whole `block`-wide blocks; an image stops only after the block
// in which its count reaches max_output, so the count may overshoot
// max_output (the stop rule of tpurpn.boxes._nms_keep_sorted_batched). The
// TPU kernel's lane planes, its chunked sweep of the keep row and its MXU
// fixpoint matvec exist for Mosaic; here:
//
// * the block has `block` threads, thread t holding box start + t;
// * cross-block suppression: each thread tests its box against the boxes
//   kept so far, which live in shared memory (or, when max_output + block
//   would not fit, in a global scratch row);
// * inside a block, thread t builds the bit mask of the earlier boxes of the
//   block whose IoU with it exceeds the threshold; one thread then walks the
//   block in order, keeping a box when it is alive and no kept bit of the
//   block is in its mask: the greedy keep set, which is the unique fixpoint
//   the TPU kernel iterates to.
//
// What bounds it: the serial chain. Config 4 (B=32, n=2000, max_output 300)
// needs some 10^5-10^6 IoU tests per image, a few microseconds of f32
// work spread over the card, and reads 64 KB an image; the chain of one
// decision after another within a block, and block after block, is what
// takes the time.
//
// Exactness: the IoU is the plain version's op for op (box_iou, built with
// -fmad=false and IEEE division), and it is symmetric bit for bit, so the
// keep mask is bit-identical to the plain version's.

#include "common.cuh"

namespace {

constexpr int kMaxBlock = 1024;
constexpr int kMaxWords = kMaxBlock / 32;
constexpr size_t kSmemLimit = 200 * 1024;

size_t block_smem_bytes(int block) {
  const int words = block / 32;
  // cbox, carea, mask rows, alive, pos
  return (size_t)block * (16 + 4 + 4 * words + 4 + 4);
}

__global__ void __launch_bounds__(kMaxBlock) nms_kernel(
    const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
    uint8_t* __restrict__ keep, int* __restrict__ count, float4* kept_box_global,
    float* kept_area_global, int n, int max_output, int cap, float iou_threshold,
    int kept_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t kept_bits[kMaxWords];
  __shared__ int s_new;
  const int block = blockDim.x, words = block / 32;
  const int b = blockIdx.x, t = threadIdx.x;
  float4* cbox = reinterpret_cast<float4*>(smem);
  float* carea = reinterpret_cast<float*>(cbox + block);
  uint32_t* mask = reinterpret_cast<uint32_t*>(carea + block);  // [block][words]
  int* alive = reinterpret_cast<int*>(mask + (size_t)block * words);
  int* pos = alive + block;
  float4* kbox;
  float* karea;
  if (kept_in_smem) {
    kbox = reinterpret_cast<float4*>(pos + block);  // 16-aligned: block % 32 == 0
    karea = reinterpret_cast<float*>(kbox + cap);
  } else {
    kbox = kept_box_global + (size_t)b * cap;
    karea = kept_area_global + (size_t)b * cap;
  }
  const float4* bx = boxes + (size_t)b * n;
  const uint8_t* vd = valid + (size_t)b * n;
  uint8_t* kp = keep + (size_t)b * n;

  int kept = 0;  // uniform over the block
  int start = 0;
  for (; start < n && kept < max_output; start += block) {
    const int j = start + t;
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int ok = 0;
    if (j < n) {
      box = bx[j];
      ok = vd[j] != 0;
    }
    const float area = box_area(box);
    cbox[t] = box;
    carea[t] = area;
    for (int k = 0; k < kept && ok; ++k)
      if (box_iou(box, area, kbox[k], karea[k]) > iou_threshold) ok = 0;
    alive[t] = ok;
    if (t < words) kept_bits[t] = 0;
    __syncthreads();  // the block's boxes are in shared memory
    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0;
      if (ok) {
        const int hi = min(t, (w + 1) * 32);
        for (int i = w * 32; i < hi; ++i)
          if (box_iou(box, area, cbox[i], carea[i]) > iou_threshold) bits |= 1u << (i - w * 32);
      }
      mask[(size_t)t * words + w] = bits;
    }
    __syncthreads();
    if (t == 0) {  // the greedy walk through the block
      int c = 0;
      for (int i = 0; i < block; ++i) {
        int p = -1;
        if (alive[i]) {
          const uint32_t* row = mask + (size_t)i * words;
          uint32_t hit = 0;
          for (int w = 0; w <= (i >> 5); ++w) hit |= row[w] & kept_bits[w];
          if (!hit) {
            kept_bits[i >> 5] |= 1u << (i & 31);
            p = c++;
          }
        }
        pos[i] = p;
      }
      s_new = c;
    }
    __syncthreads();
    const int p = pos[t];
    if (j < n) kp[j] = p >= 0;
    if (p >= 0) {
      kbox[kept + p] = box;
      karea[kept + p] = area;
    }
    kept += s_new;
    __syncthreads();  // appended boxes visible; s_new, pos and alive are read
  }
  for (int j = start + t; j < n; j += block) kp[j] = 0;  // never decided
  if (t == 0) count[b] = kept;
}

}  // namespace

TPURPN_EXPORT int nms_keep(const float* boxes, const uint8_t* valid, uint8_t* keep, int* count,
                           float* kept_box, float* kept_area, int B, int n, int max_output,
                           int block, int cap, float iou_threshold, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || block < 32 || block > kMaxBlock || block % 32 ||
      cap < 1 || cap < min(n, max_output + block - 1))
    return cudaErrorInvalidValue;
  size_t smem = block_smem_bytes(block);
  const size_t kept_bytes = (size_t)cap * 20;
  const int kept_in_smem = smem + kept_bytes <= kSmemLimit;
  if (kept_in_smem) smem += kept_bytes;
  cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  nms_kernel<<<B, block, smem, stream>>>(
      reinterpret_cast<const float4*>(boxes), valid, keep, count,
      reinterpret_cast<float4*>(kept_box), kept_area, n, max_output, cap, iou_threshold,
      kept_in_smem);
  return cudaGetLastError();
}

TPURPN_EXPORT const char* nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
