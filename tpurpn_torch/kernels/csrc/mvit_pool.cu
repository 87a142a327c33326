// MViTv2's pooling of q, k and v for Hopper (sm_90a): for every head of each
// of q, k and v, a depthwise 3x3 convolution (padding 1, no bias; one filter
// set of d channels shared by the heads) at stride s_q for q and s_kv for k
// and v, then a LayerNorm over the head's d channels (eps, affine), as one
// launch a block that reads the qkv product in place and writes the three
// pooled tensors once. Head widths d = 96 (MViTv2-T, -S, -B), 72 (-L) and
// 64 (-H), one instance each. The wrapper (tpurpn_torch/kernels/mvit_pool.py)
// launches mvit_pool_kernel once a block of the backbone, 24 times a forward
// of MViTv2-B; tpurpn_torch/backbones/mvit.py calls it.
//
// Replaces no TPU kernel: the JAX package has no MViT. On the card the same
// pooling ran as a copy that split q, k and v out of the qkv product, then
// per tensor cuDNN's depthwise conv (its bf16 output written to device
// memory) and PyTorch's LayerNorm over rows of d reading it back.
//
// What bounds it: bytes. MViTv2-B at B = 16 on the 800 x 1088 canvas (a 200
// x 272 token grid) reads of its 24 blocks' qkv products the q, k and v
// values a tap reaches, 4.89 GB (every one at strides 1 and 2; at stride 4
// the rows and columns 4 y - 1 .. 4 y + 1, 9/16 of a slice, 5.26 GB in
// whole slices), and writes the pooled q, k and v, 3.35 GB: 2.46 ms at 3.35
// TB/s. Its arithmetic is 9 f32 products a pooled value (30 GFLOP) and the
// norm's dozen operations, about 2 G warp instructions a batch: under the
// byte bound only if the lanes stay busy, so the design keeps operand
// traffic in shared memory and registers and converts every value once.
//
// Layout. qkv is (B, H, W, 3C) bf16 read by its strides (channels unit
// stride): q at channel offset 0, k at C, v at 2C, head h's d channels a
// contiguous run of 2 d bytes at h * d inside each. Outputs are (B, H', W',
// h, d) contiguous, H' = ceil(H / s).
//
// Design. A persistent block of 256 threads walks work items n = blockIdx.x
// + k * gridDim.x over (q, k, v) x images x heads x output tiles (tile
// column fastest, so that the blocks in flight share halos in L2). An item
// stages its input tile with its one-pixel halo, one head's d channels a
// pixel, into shared memory by cp.async 16 bytes a thread; a halo pixel
// outside the grid is zero-filled by the copy itself (src-size 0), which is
// the conv's padding. Two stages: the next item's copies are in flight
// while this item computes. Tiles: 8 x 16 outputs at stride 1 (10 x 18
// staged pixels), 4 x 8 at stride 2 (9 x 17), 2 x 8 at stride 4, where
// only the input rows and columns that a tap reads are staged (3 of every
// 4: 6 x 24). A group of 16 lanes takes R neighbouring output pixels of a
// row (R = 2 at strides 1 and 2, whose taps share staged columns, so each
// staged pixel is loaded and converted once for both; R = 1 at stride 4),
// d / 8 lanes 8 channels each (12 at d = 96; the others idle: a head's
// channels do not split over a warp's halves otherwise): the 9 taps as f32
// FMAs in tap order (ky, kx) from 16-byte shared loads, the filter's 72
// taps for its channels in registers; then the mean and the variance over
// the d f32 sums (two passes, shuffles within the 16 lanes, the R outputs'
// chains interleaved: the conv's sum is never rounded to bf16), the affine,
// one rounding to bf16 and one 16-byte store a lane and output. A warp
// whose outputs all lie past the grid's edge skips its pass. The filters
// and affines (bf16 values, the module's compute copies) come as one f32
// pack, copied to shared memory once a block.

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 16; // output pixels a pass of the block
constexpr int kRows = 11;              // pack rows of q, k or v: 9 taps, gamma, beta
constexpr int kStagePix = 180;         // the largest staged tile (stride 1: 10 x 18)
constexpr int kMaxDevices = 64;

// A head width D: its 16-byte vectors a head pixel (one a lane), the bytes
// of a staged head pixel, the f32 pack, a stage, the dynamic shared memory.
template <int D>
struct Width {
  static_assert(D % 8 == 0 && D / 8 <= 16, "a head's vectors fit a lane group");
  static constexpr int kChunks = D / 8, kPixBytes = D * 2, kParams = 3 * kRows * D;
  static constexpr int kStageBytes = kStagePix * kPixBytes;
  static constexpr size_t kSmem = (size_t)kParams * 4 + 2 * kStageBytes;
};

// Output tiles (TH x TW) and the outputs a lane group takes along a row (R).
template <int S> struct Tile;
template <> struct Tile<1> { static constexpr int TH = 8, TW = 16, R = 2; };
template <> struct Tile<2> { static constexpr int TH = 4, TW = 8, R = 2; };
template <> struct Tile<4> { static constexpr int TH = 2, TW = 8, R = 1; };

// An output tile at stride S and its staged input: staged row j is input
// row S * y0 - 1 + (j / P) * S + j % P (y0 the tile's first output row),
// and output row i's tap dy reads staged row P * i + dy. At S <= 3 the
// staged rows are every input row from S * y0 - 1 on; at S = 4 only those
// a tap reads. The same for columns.
template <int S>
struct Geo {
  static constexpr int TH = Tile<S>::TH, TW = Tile<S>::TW, R = Tile<S>::R;
  static constexpr int P = S < 3 ? S : 3;
  static constexpr int SH = P * (TH - 1) + 3, SW = P * (TW - 1) + 3;
  static constexpr int PIX = SH * SW;
  static_assert(PIX <= kStagePix, "staged tile");
  static_assert(TW % R == 0 && TH * TW % (kGroups * R) == 0, "whole passes");
  static_assert(R == 1 || P == S, "neighbouring outputs share staged columns");
};

template <typename T>
__device__ __forceinline__ T pick(const T (&v)[2], int kv) { return kv ? v[1] : v[0]; }

struct Args {
  const __nv_bfloat16* qkv;
  int H, W, sb, sh, sw;  // input grid and element strides of image, row, column
  int heads, C;
  int s[2];              // stride of q, of k and v
  int ho[2], wo[2];      // output grid of q, of k and v
  int tiles_x[2], tiles[2];  // output tiles of one image and head: a row, in all
  int nq, nkv, total;    // items of q, of k (as of v), in all
  const float* params;   // (3, kRows, D) f32
  __nv_bfloat16* out[3];
  float eps;
};

struct Job {
  int which, b, head, y0, x0;
};

__device__ __forceinline__ Job decode(const Args& a, int n) {
  Job j;
  int r = n;
  if (r < a.nq) {
    j.which = 0;
  } else {
    r -= a.nq;
    j.which = 1 + r / a.nkv;
    r %= a.nkv;
  }
  const int kv = j.which > 0;
  const int tiles = pick(a.tiles, kv), tiles_x = pick(a.tiles_x, kv);
  const int per_image = a.heads * tiles;
  j.b = r / per_image;
  r %= per_image;
  j.head = r / tiles;
  r %= tiles;
  const int ty = r / tiles_x, tx = r % tiles_x;
  const int S = pick(a.s, kv);
  j.y0 = ty * (S == 1 ? Tile<1>::TH : S == 2 ? Tile<2>::TH : Tile<4>::TH);
  j.x0 = tx * (S == 1 ? Tile<1>::TW : S == 2 ? Tile<2>::TW : Tile<4>::TW);
  return j;
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of item j's staged tile into `buf` (this thread's share).
template <int D, int S>
__device__ __forceinline__ void stage(const Args& a, const Job& j, unsigned char* buf) {
  using G = Geo<S>;
  constexpr int kChunks = Width<D>::kChunks, kPixBytes = Width<D>::kPixBytes;
  const __nv_bfloat16* base = a.qkv + (size_t)j.b * a.sb + j.which * a.C + j.head * D;
  const int r0 = S * j.y0 - 1, c0 = S * j.x0 - 1;
  for (int v = threadIdx.x; v < G::PIX * kChunks; v += kThreads) {
    const int p = v / kChunks, ch = v % kChunks;
    const int sy = p / G::SW, sx = p % G::SW;
    const int r = r0 + (sy / G::P) * S + sy % G::P;
    const int c = c0 + (sx / G::P) * S + sx % G::P;
    const bool in = (unsigned)r < (unsigned)a.H && (unsigned)c < (unsigned)a.W;
    const __nv_bfloat16* src = in ? base + (size_t)r * a.sh + (size_t)c * a.sw + ch * 8 : a.qkv;
    cp_async16_zfill(buf + p * kPixBytes + ch * 16, src, in ? 16 : 0);
  }
}

template <int D>
__device__ __forceinline__ void stage_item(const Args& a, int n, unsigned char* buf) {
  const Job j = decode(a, n);
  switch (pick(a.s, j.which > 0)) {
    case 1: stage<D, 1>(a, j, buf); break;
    case 2: stage<D, 2>(a, j, buf); break;
    default: stage<D, 4>(a, j, buf); break;
  }
}

__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  f[0] = bf16_lo(v.x), f[1] = bf16_hi(v.x), f[2] = bf16_lo(v.y), f[3] = bf16_hi(v.y);
  f[4] = bf16_lo(v.z), f[5] = bf16_hi(v.z), f[6] = bf16_lo(v.w), f[7] = bf16_hi(v.w);
}

// Two f32 as two bf16, round to nearest even, lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Sums over the 16 lanes of this lane's half-warp, R at once.
template <int R>
__device__ __forceinline__ void group_sums(float (&x)[R]) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] += __shfl_xor_sync(0xffffffffu, x[r], o);
}

// Pool and normalise item j's outputs from its staged tile. Lane ch < D / 8
// of a group owns channels 8 ch .. 8 ch + 7 of R neighbouring outputs of a
// row; each staged pixel they read is loaded and converted once for all R.
// A warp whose outputs all lie outside the grid skips the pass; otherwise
// every lane takes part (the shuffles span the warp).
template <int D, int S>
__device__ __forceinline__ void compute(const Args& a, const Job& j, const unsigned char* buf,
                                        const float (&tap)[9][8], const float* affine) {
  using G = Geo<S>;
  constexpr int kChunks = Width<D>::kChunks, kPixBytes = Width<D>::kPixBytes;
  constexpr int R = G::R, NC = S * (R - 1) + 3;  // staged columns a group reads a row
  const int ch = threadIdx.x & 15, group = threadIdx.x >> 4;
  const bool act = ch < kChunks;
  const int kv = j.which > 0;
  const int ho = pick(a.ho, kv), wo = pick(a.wo, kv);
  __nv_bfloat16* out = j.which == 0 ? a.out[0] : j.which == 1 ? a.out[1] : a.out[2];
#pragma unroll 1
  for (int o = group; o < G::TH * G::TW / R; o += kGroups) {
    const int i = o / (G::TW / R), x = o % (G::TW / R) * R;
    const int y = j.y0 + i, x0 = j.x0 + x;
    const bool live = y < ho && x0 < wo;
    if (!__any_sync(0xffffffffu, live)) continue;
    float acc[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
    if (act && live) {
      const unsigned char* px = buf + (G::P * i * G::SW + G::P * x) * kPixBytes + ch * 16;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(px + (dy * G::SW + c) * kPixBytes), f);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int dx = c - S * r;
            if (dx >= 0 && dx < 3) {
#pragma unroll
              for (int k = 0; k < 8; ++k) acc[r][k] = fmaf(f[k], tap[dy * 3 + dx][k], acc[r][k]);
            }
          }
        }
    }
    float mean[R], q[R], rstd[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mean[r] = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) mean[r] += acc[r][k];
    }
    group_sums(mean);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mean[r] *= 1.0f / D;
      q[r] = 0.f;
      if (act) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          acc[r][k] -= mean[r];
          q[r] = fmaf(acc[r][k], acc[r][k], q[r]);
        }
      }
    }
    group_sums(q);
#pragma unroll
    for (int r = 0; r < R; ++r) rstd[r] = rsqrtf(q[r] * (1.0f / D) + a.eps);
    if (act && live) {
      const float4* g = reinterpret_cast<const float4*>(affine + 9 * D + ch * 8);
      const float4* b = reinterpret_cast<const float4*>(affine + 10 * D + ch * 8);
      const float4 g0 = g[0], g1 = g[1], b0 = b[0], b1 = b[1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (x0 + r >= wo) break;
        const float* v = acc[r];
        const float t = rstd[r];
        uint4 w;
        w.x = pack2(fmaf(v[0] * t, g0.x, b0.x), fmaf(v[1] * t, g0.y, b0.y));
        w.y = pack2(fmaf(v[2] * t, g0.z, b0.z), fmaf(v[3] * t, g0.w, b0.w));
        w.z = pack2(fmaf(v[4] * t, g1.x, b1.x), fmaf(v[5] * t, g1.y, b1.y));
        w.w = pack2(fmaf(v[6] * t, g1.z, b1.z), fmaf(v[7] * t, g1.w, b1.w));
        const size_t pix = ((size_t)j.b * ho + y) * wo + x0 + r;
        *reinterpret_cast<uint4*>(out + (pix * a.heads + j.head) * D + ch * 8) = w;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) mvit_pool_kernel(const Args a) {
  using Wd = Width<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* params = reinterpret_cast<float*>(smem);
  unsigned char* stages = smem + Wd::kParams * 4;
  for (int i = threadIdx.x; i < Wd::kParams; i += kThreads) params[i] = a.params[i];

  int n = blockIdx.x;
  if (n < a.total) stage_item<D>(a, n, stages);
  cp_async_commit();
  const int ch = min(threadIdx.x & 15, Wd::kChunks - 1);  // idle lanes hold the last lane's taps
  float tap[9][8];
  int held = -1;
  for (int it = 0; n < a.total; ++it, n += gridDim.x) {
    if (n + (int)gridDim.x < a.total)
      stage_item<D>(a, n + gridDim.x, stages + ((it + 1) & 1) * Wd::kStageBytes);
    cp_async_commit();
    cp_async_wait<1>();  // this item's copies (all but the group just committed) have landed
    __syncthreads();
    const Job j = decode(a, n);
    const float* affine = params + j.which * kRows * D;
    if (j.which != held) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const float4 lo = *reinterpret_cast<const float4*>(affine + t * D + ch * 8);
        const float4 hi = *reinterpret_cast<const float4*>(affine + t * D + ch * 8 + 4);
        tap[t][0] = lo.x; tap[t][1] = lo.y; tap[t][2] = lo.z; tap[t][3] = lo.w;
        tap[t][4] = hi.x; tap[t][5] = hi.y; tap[t][6] = hi.z; tap[t][7] = hi.w;
      }
      held = j.which;
    }
    const unsigned char* buf = stages + (it & 1) * Wd::kStageBytes;
    switch (pick(a.s, j.which > 0)) {
      case 1: compute<D, 1>(a, j, buf, tap, affine); break;
      case 2: compute<D, 2>(a, j, buf, tap, affine); break;
      default: compute<D, 4>(a, j, buf, tap, affine); break;
    }
    __syncthreads();  // every lane is done with this stage before it is refilled
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

void tiles_of(int S, int ho, int wo, int* tiles_x, int* tiles) {
  const int th = S == 1 ? Tile<1>::TH : S == 2 ? Tile<2>::TH : Tile<4>::TH;
  const int tw = S == 1 ? Tile<1>::TW : S == 2 ? Tile<2>::TW : Tile<4>::TW;
  *tiles_x = (wo + tw - 1) / tw;
  *tiles = *tiles_x * ((ho + th - 1) / th);
}

// Launch the kernel of head width D: as many blocks as stay resident on the
// device (found at the first call on it), at most one an item.
template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  constexpr size_t smem = Width<D>::kSmem;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(mvit_pool_kernel<D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mvit_pool_kernel<D>,
                                                             kThreads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
  }
  const int blocks = min(a.total, resident[device]);
  mvit_pool_kernel<D><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Pool q, k and v of one MViT block: qkv (B, H, W, 3 C) bf16 with element
// strides (sb, sh, sw) of image, row and column and unit channel stride, C
// = heads * d; params (3, 11, d) f32: for q, k, v the taps (ky * 3 + kx,
// channel), gamma, beta; out_q (B, ceil(H / stride_q), ceil(W / stride_q),
// heads, d) and out_k, out_v (B, ceil(H / stride_kv), ..., heads, d) bf16
// contiguous. Head widths d of 64, 72 and 96 (MViTv2-H's, -L's, and -T/S/B's)
// and strides 1, 2 and 4; others, unaligned pointers or strides that are not
// whole 16-byte vectors are refused.
TPURPN_EXPORT int mvit_pool(const void* qkv, int B, int H, int W, int sb, int sh, int sw,
                            int heads, int d, int stride_q, int stride_kv, const float* params,
                            void* out_q, void* out_k, void* out_v, float eps,
                            cudaStream_t stream) {
  const auto ok_stride = [](int s) { return s == 1 || s == 2 || s == 4; };
  if (B <= 0 || H <= 0 || W <= 0 || heads <= 0 || (d != 64 && d != 72 && d != 96) ||
      !ok_stride(stride_q) || !ok_stride(stride_kv) || sb % 8 || sh % 8 || sw % 8 ||
      !aligned16(qkv) || !aligned16(params) || !aligned16(out_q) || !aligned16(out_k) ||
      !aligned16(out_v))
    return cudaErrorInvalidValue;
  Args a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.H = H, a.W = W, a.sb = sb, a.sh = sh, a.sw = sw;
  a.heads = heads, a.C = heads * d;
  a.s[0] = stride_q, a.s[1] = stride_kv;
  long long items[2];
  for (int kv = 0; kv < 2; ++kv) {
    a.ho[kv] = (H + a.s[kv] - 1) / a.s[kv];
    a.wo[kv] = (W + a.s[kv] - 1) / a.s[kv];
    tiles_of(a.s[kv], a.ho[kv], a.wo[kv], &a.tiles_x[kv], &a.tiles[kv]);
    items[kv] = (long long)B * heads * a.tiles[kv];
  }
  if (items[0] + 2 * items[1] >= (1LL << 31)) return cudaErrorInvalidValue;
  a.nq = (int)items[0], a.nkv = (int)items[1], a.total = (int)(items[0] + 2 * items[1]);
  a.params = params;
  a.out[0] = static_cast<__nv_bfloat16*>(out_q);
  a.out[1] = static_cast<__nv_bfloat16*>(out_k);
  a.out[2] = static_cast<__nv_bfloat16*>(out_v);
  a.eps = eps;
  return d == 96 ? launch<96>(a, stream) : d == 72 ? launch<72>(a, stream) : launch<64>(a, stream);
}

TPURPN_EXPORT const char* mvit_pool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
