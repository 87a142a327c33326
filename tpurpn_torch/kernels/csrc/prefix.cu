// The serving prefix of MobileNetV2 (expanded_conv and blocks 1-6, after the
// Conv1 activations) for Hopper (sm_90a): each of its 20 convolutions is one
// launch that reads its input once, applies the bias, ReLU6 and (for a
// residual block's project) the residual add in registers, and writes its
// output once. The wrapper (tpurpn_torch/kernels/prefix.py) launches
// prefix_pointwise 13 times and prefix_depthwise 7 times a batch on one
// stream; tpurpn_torch/inference.py walks the blocks.
//
// Replaces no TPU kernel: tpurpn left these convolutions to XLA
// (tpurpn/inference.py runs the prefix as the flax module). On the card the
// same convolutions went through cuDNN with a separate bias add, clamp,
// residual add, pad and copy each, 104 operations a batch; this library
// takes their place in the serving path only.
//
// What bounds it: bytes. At B = 128 and 500 px the 20 convolutions, each
// reading its input and writing its output once, move 12.4 GB (3.7 ms at
// 3.35 TB/s); their arithmetic is 0.96 GFLOP of 1x1 products an image
// (0.12 ms on the tensor cores at B = 128) and 0.145 GFLOP of depthwise taps
// (about 0.3 ms in f32). So each kernel is built to stream: 16 bytes a
// thread along whole pixel rows, loads in flight while the last tile
// computes, and no pass over device memory besides the one in and the one
// out.
//
// prefix_pointwise_kernel: a 1x1 convolution as the product of NHWC bf16
// pixel rows [B*H*W, C_IN] with the weights [C_IN, C_OUT], f32 accumulation,
// then f32 bias, optional ReLU6, one bf16 rounding and, for a residual
// project, a bf16 add of the block input: bf16(bf16(acc + b) + x), as the IR
// stage rounds. Specs (C_IN -> C_OUT): expands 16->96, 24->144, 32->192 (with
// ReLU6); projects 32->16, 96->24, 144->24 (+ residual), 144->32, 192->32
// (+ residual), 192->64. Design: a persistent block (two warpgroups) keeps
// the whole weight matrix in shared memory (at most 24 KB at 192 -> 64), in
// the K-major 64-byte-swizzled layout (kernels/prefix.py packs it once), and
// walks tiles of TM = 128 consecutive pixels, one 64-row M-tile a
// warpgroup: the tile's rows (and the residual's) arrive by cp.async, 16
// bytes a thread, straight into their swizzled places, STAGES tiles ahead
// (2, or 3 where a tile is at most 16 KB), while the current tile's wgmma
// m64n{C_OUT}k16 runs and its epilogue stores. The epilogue stages the bf16
// tile in shared memory (a row pitch of 4 mod 8 words: the fragment stores
// fall in 32 banks) and copies it out 16 bytes a thread along the tile's
// contiguous rows, adding the residual there. A K step is 16 channels in
// 32-channel planes: C_IN = 24 runs two steps over zeroed pad channels (the
// pack's rows there are zero too), 144 runs nine steps of its 160-wide
// planes and never reads the last half plane.
//
// prefix_depthwise_kernel: a 3x3 depthwise convolution at stride 1 or 2
// over NHWC bf16, f32 sums in tpurpn's tap order (ky, kx), then f32 bias,
// ReLU6, one bf16 rounding. The taps are the bf16 weights held as f32, so
// each product is exact and the sum rounds as the plain version's does:
// bit for bit. TF "SAME" padding comes from H, W and the stride in the
// kernel ((0, 1) at even sizes and (1, 1) at odd ones at stride 2); taps
// outside the image read zero by predicate, so no padded copy exists.
// Specs (C, stride): (32, 1) at 250^2, (96, 2) at 250^2 -> 125^2, (144, 1)
// at 125^2, (144, 2) at 125^2 -> 63^2, (192, 1) at 63^2, (192, 2) at
// 63^2 -> 32^2 (and any H, W: 640 px serves 320^2 .. 40^2). Design: a
// thread owns 8 channels (one 16-byte vector) of one output column and
// walks ROWS output rows down it with the 3x3 window in registers: each
// step loads only the input rows the window gains (one at stride 1, two at
// stride 2), issued a step ahead, so each input row comes from device
// memory once a column run; the neighbouring columns' loads of the same
// pixels, made by the same warp, hit L1. Consecutive threads take
// consecutive vectors of a pixel, so a warp's load is one contiguous span.
// The 72 taps and 8 biases of the thread's channels stay in registers for
// the whole run.

#include "wgmma.cuh"

namespace {

constexpr int kAlign = 1024;    // slack to align the dynamic shared memory
constexpr int kThreads = 256;   // pointwise: two warpgroups
constexpr int TM = 128;         // pointwise: pixels a tile, 64 a warpgroup
constexpr int kDwThreads = 128; // depthwise: threads a block
constexpr int ROWS = 8;         // depthwise: output rows a thread walks
constexpr int kMaxDevices = 64; // pointwise: launch settings cached per device

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread's copies are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bf16(a + b) for each of the 8 bf16 of two 16-byte words.
__device__ __forceinline__ uint4 add_bf16x8(uint4 a, uint4 b) {
  return make_uint4(pack_bf16(bf16_lo(a.x) + bf16_lo(b.x), bf16_hi(a.x) + bf16_hi(b.x)),
                    pack_bf16(bf16_lo(a.y) + bf16_lo(b.y), bf16_hi(a.y) + bf16_hi(b.y)),
                    pack_bf16(bf16_lo(a.z) + bf16_lo(b.z), bf16_hi(a.z) + bf16_hi(b.z)),
                    pack_bf16(bf16_lo(a.w) + bf16_lo(b.w), bf16_hi(a.w) + bf16_hi(b.w)));
}

// The pointwise kernel's shared-memory plan for one spec.
template <int C_IN, int C_OUT, bool RES>
struct Pw {
  static constexpr int K_IN = round_up(C_IN, 32);  // input channels held: whole planes
  static constexpr int KSTEPS = (C_IN + 15) / 16;  // wgmma K steps that carry channels
  static constexpr int A_BYTES = TM * K_IN * 2;    // a tile of input rows
  static constexpr int R_BYTES = RES ? TM * C_OUT * 2 : 0;  // a tile of residual rows
  static constexpr int W_BYTES = round_up(K_IN * C_OUT * 2, kAlign);
  static constexpr int STAGES = A_BYTES <= 16384 ? 3 : 2;
  // staged output words a pixel: 4 mod 8, so that the fragment stores of a
  // warp (8 pixels x 4 words) fall in 32 banks
  static constexpr int PITCH = (C_OUT / 2) % 8 == 4 ? C_OUT / 2 : C_OUT / 2 + 4;
  static constexpr size_t SMEM =
      kAlign + W_BYTES + STAGES * (A_BYTES + R_BYTES) + TM * PITCH * 4 + C_OUT * 4;
  static_assert(C_IN % 8 == 0 && C_OUT % 8 == 0 && C_OUT <= 256, "pointwise widths");
  static_assert(SMEM <= 232448, "pointwise shared memory");
};

template <int C_IN, int C_OUT, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads) prefix_pointwise_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ pack,
    const float* __restrict__ bias, int rows) {
  using S = Pw<C_IN, C_OUT, RES>;
  constexpr int QI = C_IN / 8;   // 16-byte pieces of an input pixel
  constexpr int QO = C_OUT / 8;  // ... of an output pixel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ws = align_smem(smem_raw);  // [K_IN / 32][C_OUT][32] swizzled
  unsigned char* as = ws + S::W_BYTES;       // STAGES x [K_IN / 32][TM][32] swizzled
  unsigned char* rs = as + S::STAGES * S::A_BYTES;                         // STAGES x [TM][C_OUT]
  uint32_t* ot = reinterpret_cast<uint32_t*>(rs + S::STAGES * S::R_BYTES);  // [TM][PITCH]
  float* bs = reinterpret_cast<float*>(ot + TM * S::PITCH);

  const int t = threadIdx.x, lane = t & 31, wg = t >> 7, wi = (t >> 5) & 3;
  const int ntiles = (rows + TM - 1) / TM;

  // the pad channels [C_IN, 16 * KSTEPS) the last K step reads are zero
  // (C_IN = 24); no copy ever writes them
  if (C_IN % 16 != 0)
    for (int i = t; i < S::STAGES * TM; i += kThreads)
      *reinterpret_cast<uint4*>(as + (i / TM) * S::A_BYTES + sw64(TM, i % TM, C_IN)) =
          make_uint4(0u, 0u, 0u, 0u);
  for (int i = t; i < C_OUT; i += kThreads) bs[i] = bias[i];
  const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(pack);
  for (int i = t; i < S::K_IN * C_OUT * 2 / 16; i += kThreads)
    cp_async16(ws + 16 * i, wsrc + 16 * i);

  // tile `tile`'s input rows (and residual rows) into stage s, as one group
  auto load = [&](int tile, int s) {
    if (tile < ntiles) {
      const int r0 = tile * TM, n = min(TM, rows - r0);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x + (size_t)r0 * C_IN);
      unsigned char* a = as + s * S::A_BYTES;
      for (int i = t; i < n * QI; i += kThreads)
        cp_async16(a + sw64(TM, i / QI, 8 * (i % QI)), src + 16 * i);
      if (RES) {
        const unsigned char* rsrc =
            reinterpret_cast<const unsigned char*>(res + (size_t)r0 * C_OUT);
        for (int i = t; i < n * QO; i += kThreads)
          cp_async16(rs + s * S::R_BYTES + 16 * i, rsrc + 16 * i);
      }
    }
    cp_async_commit();
  };

  int tile = blockIdx.x;
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) load(tile + s * gridDim.x, s);  // the weights with the first

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int s = it % S::STAGES;
    cp_async_wait<S::STAGES - 2>();  // this thread's copies of the tile have landed
    fence_proxy_async();             // ... and the zeroed pad, for wgmma
    __syncthreads();                 // everyone's; the last tile is out of every buffer
    load(tile + (S::STAGES - 1) * gridDim.x, (it + S::STAGES - 1) % S::STAGES);

    float acc[C_OUT / 2];
#pragma unroll
    for (int i = 0; i < C_OUT / 2; ++i) acc[i] = 0.0f;
    fence_regs(acc);
    wgmma_fence();
    const unsigned char* a = as + s * S::A_BYTES + wg * 64 * 64;
#pragma unroll
    for (int ks = 0; ks < S::KSTEPS; ++ks) {
      const int koff = (ks & 1) * 32;
      wgmma_bf16(acc, desc_sw64(smem_u32(a + (ks >> 1) * TM * 64 + koff)),
                 desc_sw64(smem_u32(ws + (ks >> 1) * C_OUT * 64 + koff)));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // + bias, ReLU6, one bf16 rounding, into the staged tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 64 * wg + 16 * wi + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < C_OUT / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        float v0 = acc[4 * j + 2 * h] + bs[c], v1 = acc[4 * j + 2 * h + 1] + bs[c + 1];
        if (RELU) {
          v0 = relu6f(v0);
          v1 = relu6f(v1);
        }
        ot[p * S::PITCH + c / 2] = pack_bf16(v0, v1);
      }
    }
    __syncthreads();
    // out 16 bytes a thread along the tile's contiguous rows, + the residual
    const int r0 = tile * TM, n = min(TM, rows - r0);
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)r0 * C_OUT);
    const uint4* rsd = reinterpret_cast<const uint4*>(rs + s * S::R_BYTES);
    for (int i = t; i < n * QO; i += kThreads) {
      uint4 v = *reinterpret_cast<const uint4*>(ot + (i / QO) * S::PITCH + 4 * (i % QO));
      if (RES) v = add_bf16x8(v, rsd[i]);
      dst[i] = v;
    }
  }
  cp_async_wait<0>();
}

// The 8 outputs of one window (rows a, b, c of 3 pixels each), in tpurpn's
// tap order, + bias, ReLU6, bf16.
__device__ __forceinline__ uint4 depthwise_8(const uint4 (&a)[3], const uint4 (&b)[3],
                                             const uint4 (&c)[3], const float (&w)[9][8],
                                             const float (&bv)[8]) {
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const uint4 q = (tap < 3 ? a : tap < 6 ? b : c)[tap % 3];
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] = __fmaf_rn(bf16_lo(u[k]), w[tap][2 * k], acc[2 * k]);
      acc[2 * k + 1] = __fmaf_rn(bf16_hi(u[k]), w[tap][2 * k + 1], acc[2 * k + 1]);
    }
  }
  return make_uint4(pack_bf16(relu6f(acc[0] + bv[0]), relu6f(acc[1] + bv[1])),
                    pack_bf16(relu6f(acc[2] + bv[2]), relu6f(acc[3] + bv[3])),
                    pack_bf16(relu6f(acc[4] + bv[4]), relu6f(acc[5] + bv[5])),
                    pack_bf16(relu6f(acc[6] + bv[6]), relu6f(acc[7] + bv[7])));
}

template <int C, int STRIDE>
__global__ void __launch_bounds__(kDwThreads) prefix_depthwise_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    const float* __restrict__ taps, const float* __restrict__ bias, int H, int W) {
  constexpr int V = C / 8;              // 16-byte vectors a pixel
  constexpr int XW = kDwThreads / V;    // output columns a block
  const int Ho = (H + STRIDE - 1) / STRIDE, Wo = (W + STRIDE - 1) / STRIDE;
  const int t = threadIdx.x, xl = t / V, v = t % V;
  const int ox = blockIdx.x * XW + xl, oy0 = blockIdx.y * ROWS;
  if (xl >= XW || ox >= Wo) return;
  // TF SAME: the extra pixel after
  const int pt = max((Ho - 1) * STRIDE + 3 - H, 0) / 2;
  const int pl = max((Wo - 1) * STRIDE + 3 - W, 0) / 2;
  const uint4* img = reinterpret_cast<const uint4*>(x) + (size_t)blockIdx.z * H * W * V + v;
  uint4* dst = reinterpret_cast<uint4*>(out) + (size_t)blockIdx.z * Ho * Wo * V + v;

  float w[9][8], bv[8];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const float4 lo = reinterpret_cast<const float4*>(taps + tap * C + 8 * v)[0];
    const float4 hi = reinterpret_cast<const float4*>(taps + tap * C + 8 * v)[1];
    w[tap][0] = lo.x; w[tap][1] = lo.y; w[tap][2] = lo.z; w[tap][3] = lo.w;
    w[tap][4] = hi.x; w[tap][5] = hi.y; w[tap][6] = hi.z; w[tap][7] = hi.w;
  }
  {
    const float4 lo = reinterpret_cast<const float4*>(bias + 8 * v)[0];
    const float4 hi = reinterpret_cast<const float4*>(bias + 8 * v)[1];
    bv[0] = lo.x; bv[1] = lo.y; bv[2] = lo.z; bv[3] = lo.w;
    bv[4] = hi.x; bv[5] = hi.y; bv[6] = hi.z; bv[7] = hi.w;
  }

  const int ix = ox * STRIDE - pl;
  bool col[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) col[d] = ix + d >= 0 && ix + d < W;
  // the 3 pixels of input row iy under this column's window (zero outside)
  auto load_row = [&](int iy, uint4 (&r)[3]) {
    const bool in = iy >= 0 && iy < H;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      r[d] = in && col[d] ? __ldg(img + ((size_t)iy * W + ix + d) * V)
                          : make_uint4(0u, 0u, 0u, 0u);
  };

  // the window of output row oy is input rows iy .. iy + 2, iy = oy * STRIDE - pt
  uint4 r0[3], r1[3], r2[3];
  int iy = oy0 * STRIDE - pt;
  load_row(iy, r0);
  load_row(iy + 1, r1);
  load_row(iy + 2, r2);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int oy = oy0 + r;
    if (oy >= Ho) break;
    // the next step's rows, in flight while this one computes
    uint4 n1[3], n2[3];
    if (r + 1 < ROWS) {
      if (STRIDE == 2) load_row(iy + 3, n1);
      load_row(iy + STRIDE + 2, n2);
    }
    dst[((size_t)oy * Wo + ox) * V] = depthwise_8(r0, r1, r2, w, bv);
    iy += STRIDE;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (STRIDE == 1) {
        r0[d] = r1[d];
        r1[d] = r2[d];
      } else {
        r0[d] = r2[d];
        r1[d] = n1[d];
      }
      r2[d] = n2[d];
    }
  }
}

template <int C_IN, int C_OUT, bool RELU, bool RES>
cudaError_t launch_pointwise(const void* x, const void* res, void* out, const void* pack,
                             const float* bias, int rows, cudaStream_t stream) {
  using S = Pw<C_IN, C_OUT, RES>;
  auto kernel = prefix_pointwise_kernel<C_IN, C_OUT, RELU, RES>;
  // once a device: the shared-memory limit, then how many blocks fit on the
  // card at once (persistent blocks, at most a tile each)
  static int resident[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)S::SMEM)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                             S::SMEM)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
  }
  const int blocks = min((rows + TM - 1) / TM, resident[device]);
  kernel<<<blocks, kThreads, S::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(pack), bias, rows);
  return cudaGetLastError();
}

template <int C, int STRIDE>
cudaError_t launch_depthwise(const void* x, void* out, const float* taps, const float* bias,
                             int B, int H, int W, cudaStream_t stream) {
  constexpr int XW = kDwThreads / (C / 8);
  const int Ho = (H + STRIDE - 1) / STRIDE, Wo = (W + STRIDE - 1) / STRIDE;
  const dim3 grid((Wo + XW - 1) / XW, (Ho + ROWS - 1) / ROWS, B);
  prefix_depthwise_kernel<C, STRIDE><<<grid, kDwThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), taps, bias, H, W);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One 1x1 convolution of the prefix: rows pixels (B*H*W) of c_in bf16 ->
// c_out bf16, + bias (f32), ReLU6 when relu6, + res (rows x c_out bf16) when
// res is not null. `pack` is the weights' shared-memory image
// (kernels/prefix.py: pointwise_pack), pack_elems = round_up(c_in, 32) *
// c_out bf16. Specs (c_in, c_out, relu6, residual): (32, 16, 0, 0),
// (16, 96, 1, 0), (96, 24, 0, 0), (24, 144, 1, 0), (144, 24, 0, 1),
// (144, 32, 0, 0), (32, 192, 1, 0), (192, 32, 0, 1), (192, 64, 0, 0); others
// are refused.
TPURPN_EXPORT int prefix_pointwise(const void* x, const void* res, void* out, const void* pack,
                                   int pack_elems, const float* bias, int rows, int c_in,
                                   int c_out, int relu6, cudaStream_t stream) {
  const bool r = res != nullptr;
  if (rows <= 0 || pack_elems != round_up(c_in, 32) * c_out || !aligned16(x) ||
      !aligned16(out) || !aligned16(pack) || !aligned16(res) || !aligned16(bias))
    return cudaErrorInvalidValue;
#define TPURPN_PW(CI, CO, RL, RS)                                                       \
  if (c_in == CI && c_out == CO && (relu6 != 0) == RL && r == RS)                       \
    return launch_pointwise<CI, CO, RL, RS>(x, res, out, pack, bias, rows, stream);
  TPURPN_PW(32, 16, false, false)
  TPURPN_PW(16, 96, true, false)
  TPURPN_PW(96, 24, false, false)
  TPURPN_PW(24, 144, true, false)
  TPURPN_PW(144, 24, false, true)
  TPURPN_PW(144, 32, false, false)
  TPURPN_PW(32, 192, true, false)
  TPURPN_PW(192, 32, false, true)
  TPURPN_PW(192, 64, false, false)
#undef TPURPN_PW
  return cudaErrorInvalidValue;
}

// One 3x3 depthwise convolution of the prefix with TF SAME padding:
// (B, H, W, c) bf16 -> (B, ceil(H / stride), ceil(W / stride), c) bf16,
// + bias, ReLU6. `taps` is (9, c) f32, tap ky * 3 + kx. Specs (c, stride):
// (32, 1), (96, 2), (144, 1), (144, 2), (192, 1), (192, 2); others are
// refused.
TPURPN_EXPORT int prefix_depthwise(const void* x, void* out, const float* taps,
                                   const float* bias, int B, int H, int W, int c, int stride,
                                   cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || !aligned16(x) || !aligned16(out) ||
      !aligned16(taps) || !aligned16(bias))
    return cudaErrorInvalidValue;
#define TPURPN_DW(CC, ST)                  \
  if (c == CC && stride == ST)             \
    return launch_depthwise<CC, ST>(x, out, taps, bias, B, H, W, stream);
  TPURPN_DW(32, 1)
  TPURPN_DW(96, 2)
  TPURPN_DW(144, 1)
  TPURPN_DW(144, 2)
  TPURPN_DW(192, 1)
  TPURPN_DW(192, 2)
#undef TPURPN_DW
  return cudaErrorInvalidValue;
}

TPURPN_EXPORT const char* prefix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
