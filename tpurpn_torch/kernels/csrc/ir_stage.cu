// Fused MobileNetV2 inverted-residual blocks for Hopper (sm_90a).
//
// Replaces tpurpn/kernels/ir_stage_pallas.py::fused_ir_stage (body
// _ir_stage_kernel): blocks 7-12 plus block_13_expand at 32x32. Each block is
// 1x1 expand -> ReLU6 -> 3x3 depthwise SAME -> ReLU6 -> 1x1 project
// (-> + residual); the tail is the 1x1 expand alone. The wrapper
// (tpurpn_torch/kernels/ir_stage.py) launches ir_block once per block and
// ir_expand once for the tail, all on one stream.
//
// Numerics, as the TPU kernel: the 1x1 convs take bf16 operands with f32
// accumulation; bias and ReLU6 in f32; the depthwise taps run in f32 over
// the f32 expanded activation; the result is rounded to bf16 after the
// depthwise ReLU6 and after the project bias; the residual add is a bf16 add.
// The library is built with -fmad=false (for the proposal kernel's exact
// IoU), so the depthwise's multiply-accumulates are explicit __fmaf_rn.
//
// What bounds it: at B=128 the stage is 127 GFLOP of 1x1 products (0.129 ms
// at 989 TFLOP/s bf16) plus 6.3 GFLOP of f32 depthwise taps (0.095 ms at
// 67 TFLOP/s), against about 168 MB of activation traffic (0.05 ms at
// 3.35 TB/s): operations. The 1x1 products run on the tensor cores as
// mma.sync m16n8k16 bf16 -> f32 (wgmma is later work); the depthwise runs as
// scalar f32 FMAs.
//
// Design: the TPU kernel keeps a whole 32x32 image in VMEM. A Hopper block
// has 227 KB of shared memory, so a thread block takes R=4 output rows of one
// image, loads R+2 input rows (a 1-row halo for the depthwise, recomputing
// the halo's expand) and walks the expand channels in chunks of 32: expand
// the chunk over the R+2 rows into shared memory (f32), run the depthwise on
// it (rounded to bf16), and add the chunk's share of the projection to
// accumulators held in registers. Chunking is exact: the depthwise is per
// channel and the projection is an f32 sum over channels. Expanded
// activations never touch device memory; only the block's input and output
// do. Operand tiles sit in shared memory as bf16 pairs (32-bit words) with a
// row stride of 4 words mod 32, so the fragment loads of one warp hit 32
// different banks. About 90 KB of shared memory: two blocks per SM.

#include "common.cuh"

namespace {

constexpr int R = 4;           // output rows per thread block
constexpr int CH = 32;         // expand channels per chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 32;      // spatial size limit (the 32x32 stage)
constexpr int P1_MAX = (R + 2) * kMaxS;  // halo'd pixels: 12 m-tiles of 16
constexpr int P_MAX = R * kMaxS;         // output pixels: 8 m-tiles, one a warp
constexpr int HS = CH + 1;     // row stride of the f32 expanded chunk, floats
constexpr int HW = CH / 2 + 4; // row stride of bf16-pair tiles with CH columns, words
constexpr int NC = 64;         // output channels per chunk of the expand-only tail
static_assert(P_MAX == 16 * kWarps, "the projection gives one m-tile to each warp");

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.0f), 6.0f); }

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2(__bfloat16_as_ushort(f32_to_bf16(lo)), __bfloat16_as_ushort(f32_to_bf16(hi)));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, col-major), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows [row0, row0 + 16), k-words [kw, kw + 8) of a word tile
// with row stride `stride` (row = pixel, k = channel pairs).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint32_t* tile, int stride,
                                       int row0, int kw, int lane) {
  const int g = lane >> 2, q = lane & 3;
  a[0] = tile[(row0 + g) * stride + kw + q];
  a[1] = tile[(row0 + g + 8) * stride + kw + q];
  a[2] = tile[(row0 + g) * stride + kw + 4 + q];
  a[3] = tile[(row0 + g + 8) * stride + kw + 4 + q];
}

// B fragment of columns [n0, n0 + 8), k-words [kw, kw + 8) of a transposed
// word tile (row = output channel, k = channel pairs).
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const uint32_t* tile, int stride,
                                       int n0, int kw, int lane) {
  const int g = lane >> 2, q = lane & 3;
  b[0] = tile[(n0 + g) * stride + kw + q];
  b[1] = tile[(n0 + g) * stride + kw + 4 + q];
}

// Load image rows [first_row, first_row + rows) of x (S x S x C_IN bf16,
// NHWC) into xs as bf16 pairs, `xw` words a pixel; rows outside are zero.
template <int C_IN>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ xb, uint32_t* xs,
                                          int xw, int first_row, int rows, int S) {
  constexpr int W = C_IN / 2;
  for (int i = threadIdx.x; i < rows * S * W; i += kThreads) {
    const int p = i / W, w = i % W;
    const int row = first_row + p / S, col = p % S;
    uint32_t v = 0;
    if (row >= 0 && row < S)
      v = reinterpret_cast<const uint32_t*>(xb + ((size_t)row * S + col) * C_IN)[w];
    xs[p * xw + w] = v;
  }
}

// Columns [c0, c0 + n) of a (K, ld) bf16 row-major matrix, transposed into
// t[col][k-pair] bf16-pair words with row stride `stride`.
__device__ __forceinline__ void load_bt(uint32_t* t, int stride, const __nv_bfloat16* m,
                                        int ld, int c0, int n, int K) {
  const uint16_t* mu = reinterpret_cast<const uint16_t*>(m);
  for (int i = threadIdx.x; i < n * (K / 2); i += kThreads) {
    const int c = i % n, kp = i / n;
    t[c * stride + kp] = pack2(mu[(size_t)(2 * kp) * ld + c0 + c],
                               mu[(size_t)(2 * kp + 1) * ld + c0 + c]);
  }
}

template <int C_IN, int C_OUT>
constexpr size_t block_smem_bytes() {
  return 4 * ((size_t)P1_MAX * (C_IN / 2 + 4) + P1_MAX * HS + P_MAX * HW +
              CH * (C_IN / 2 + 4) + C_OUT * HW);
}

template <int C_IN, int C_OUT, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads, 2) ir_block_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ we, const float* __restrict__ be,
    const float* __restrict__ kdw, const float* __restrict__ bdw,
    const __nv_bfloat16* __restrict__ wp, const float* __restrict__ bp, int S) {
  constexpr int C_EXP = 6 * C_IN;
  constexpr int XW = C_IN / 2 + 4;  // words a pixel of xs, and a row of wes
  constexpr int NT = C_OUT / 8;     // n-tiles of the projection
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem_raw);  // [P1_MAX][XW] input rows
  float* hs = reinterpret_cast<float*>(xs + P1_MAX * XW);  // [P1_MAX][HS] expanded chunk
  uint32_t* h2 = reinterpret_cast<uint32_t*>(hs + P1_MAX * HS);  // [P_MAX][HW] dw out
  uint32_t* wes = h2 + P_MAX * HW;  // [CH][XW] expand weights of the chunk, transposed
  uint32_t* wps = wes + CH * XW;    // [C_OUT][HW] project weights of the chunk, transposed

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int P1 = (R + 2) * S;  // halo'd pixels
  const int P = R * S;         // this block's output pixels (rows past S masked)

  load_rows<C_IN>(x + (size_t)b * S * S * C_IN, xs, XW, r0 - 1, R + 2, S);

  float yacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[n][e] = 0.0f;

  for (int c0 = 0; c0 < C_EXP; c0 += CH) {
    __syncthreads();  // xs is loaded; the previous chunk's buffers are free
    load_bt(wes, XW, we, C_EXP, c0, CH, C_IN);
    load_bt(wps, HW, wp + (size_t)c0 * C_OUT, C_OUT, 0, C_OUT, CH);
    __syncthreads();

    // 1. expand the chunk over the halo'd rows: 12 m-tiles x 4 n-tiles,
    //    six (m, n) tiles a warp; then bias, ReLU6, SAME zero rows -> hs
    for (int j = warp; j < (P1_MAX / 16) * (CH / 8); j += kWarps) {
      const int m = j / (CH / 8), nt = j % (CH / 8);
      if (16 * m >= P1) continue;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kw = 0; kw < C_IN / 2; kw += 8) {
        uint32_t a[4], bb[2];
        load_a(a, xs, XW, 16 * m, kw, lane);
        load_b(bb, wes, XW, 8 * nt, kw, lane);
        mma_bf16(acc, a, bb);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * m + g + 8 * h;
        if (p >= P1) continue;
        const int row = r0 - 1 + p / S;
        const bool inside = row >= 0 && row < S;  // SAME zero padding of h
        const int c = 8 * nt + 2 * q;
        hs[p * HS + c] = inside ? relu6f(acc[2 * h] + be[c0 + c]) : 0.0f;
        hs[p * HS + c + 1] = inside ? relu6f(acc[2 * h + 1] + be[c0 + c + 1]) : 0.0f;
      }
    }
    __syncthreads();

    // 2. 3x3 depthwise (stride 1, SAME) + bias + ReLU6, rounded to bf16
    {
      const int c = lane;
      float tap[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) tap[k] = kdw[k * C_EXP + c0 + c];
      const float bias = bdw[c0 + c];
      __nv_bfloat16* h2b = reinterpret_cast<__nv_bfloat16*>(h2);
      for (int p = warp; p < P; p += kWarps) {
        const int r = p / S, col = p % S;
        float acc = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int cc = col + dx - 1;
            if (cc >= 0 && cc < S)
              acc = __fmaf_rn(hs[((r + dy) * S + cc) * HS + c], tap[dy * 3 + dx], acc);
          }
        h2b[p * 2 * HW + c] = f32_to_bf16(relu6f(acc + bias));
      }
    }
    __syncthreads();

    // 3. this chunk's share of the 1x1 projection: warp w owns pixels
    //    [16w, 16w + 16) and every output channel
#pragma unroll
    for (int kw = 0; kw < CH / 2; kw += 8) {
      uint32_t a[4];
      load_a(a, h2, HW, 16 * warp, kw, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2];
        load_b(bb, wps, HW, 8 * n, kw, lane);
        mma_bf16(yacc[n], a, bb);
      }
    }
  }

  // epilogue: + bias -> bf16 (-> + residual in bf16) -> out, channel pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 16 * warp + g + 8 * h;
    const int row = r0 + p / S, col = p % S;
    if (p >= P || row >= S) continue;
    uint32_t* o = reinterpret_cast<uint32_t*>(out + (((size_t)b * S + row) * S + col) * C_OUT);
    const uint32_t* xr = xs + ((p / S + 1) * S + col) * XW;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * q;
      float y0 = round_bf16(yacc[n][2 * h] + bp[c]);
      float y1 = round_bf16(yacc[n][2 * h + 1] + bp[c + 1]);
      if (RESIDUAL) {
        const uint32_t v = xr[c / 2];
        y0 = bf16_lo(v) + y0;
        y1 = bf16_hi(v) + y1;
      }
      o[c / 2] = pack_bf16(y0, y1);
    }
  }
}

// The expand-only tail (block_13_expand): out = bf16(ReLU6(x @ we + be)),
// R rows of one image a block, NC output channels at a time.
template <int C_IN>
__global__ void __launch_bounds__(kThreads) ir_expand_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ we, const float* __restrict__ be, int S,
    int C_EXP) {
  constexpr int XW = C_IN / 2 + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem_raw);  // [P_MAX][XW]
  uint32_t* wt = xs + P_MAX * XW;                        // [NC][XW]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int P = R * S;

  load_rows<C_IN>(x + (size_t)b * S * S * C_IN, xs, XW, r0, R, S);
  for (int c0 = 0; c0 < C_EXP; c0 += NC) {
    __syncthreads();
    load_bt(wt, XW, we, C_EXP, c0, NC, C_IN);
    __syncthreads();
    float acc[NC / 8][4];
#pragma unroll
    for (int n = 0; n < NC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
    for (int kw = 0; kw < C_IN / 2; kw += 8) {
      uint32_t a[4];
      load_a(a, xs, XW, 16 * warp, kw, lane);
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) {
        uint32_t bb[2];
        load_b(bb, wt, XW, 8 * n, kw, lane);
        mma_bf16(acc[n], a, bb);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * warp + g + 8 * h;
      const int row = r0 + p / S, col = p % S;
      if (p >= P || row >= S) continue;
      uint32_t* o = reinterpret_cast<uint32_t*>(out + (((size_t)b * S + row) * S + col) * C_EXP);
#pragma unroll
      for (int n = 0; n < NC / 8; ++n) {
        const int c = c0 + 8 * n + 2 * q;
        o[c / 2] = pack_bf16(relu6f(acc[n][2 * h] + be[c]), relu6f(acc[n][2 * h + 1] + be[c + 1]));
      }
    }
  }
}

template <int C_IN, int C_OUT, bool RESIDUAL>
cudaError_t launch_block(const __nv_bfloat16* x, __nv_bfloat16* out,
                         const __nv_bfloat16* we, const float* be, const float* kdw,
                         const float* bdw, const __nv_bfloat16* wp, const float* bp,
                         int B, int S, cudaStream_t stream) {
  auto kernel = ir_block_kernel<C_IN, C_OUT, RESIDUAL>;
  const size_t smem = block_smem_bytes<C_IN, C_OUT>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + R - 1) / R, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, we, be, kdw, bdw, wp, bp, S);
  return cudaGetLastError();
}

}  // namespace

// One full inverted-residual block at stride 1: (B, S, S, c_in) bf16 ->
// (B, S, S, c_out) bf16, expansion 6. Instances: the 64->64 and 96->96
// residual blocks and the 64->96 block without residual.
TPURPN_EXPORT int ir_block(const void* x, void* out, const void* we, const float* be,
                           const float* kdw, const float* bdw, const void* wp,
                           const float* bp, int B, int S, int c_in, int c_out,
                           int residual, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || S > kMaxS) return cudaErrorInvalidValue;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto ob = static_cast<__nv_bfloat16*>(out);
  auto web = static_cast<const __nv_bfloat16*>(we);
  auto wpb = static_cast<const __nv_bfloat16*>(wp);
  if (c_in == 64 && c_out == 64 && residual)
    return launch_block<64, 64, true>(xb, ob, web, be, kdw, bdw, wpb, bp, B, S, stream);
  if (c_in == 64 && c_out == 96 && !residual)
    return launch_block<64, 96, false>(xb, ob, web, be, kdw, bdw, wpb, bp, B, S, stream);
  if (c_in == 96 && c_out == 96 && residual)
    return launch_block<96, 96, true>(xb, ob, web, be, kdw, bdw, wpb, bp, B, S, stream);
  return cudaErrorInvalidValue;
}

// The expand-only tail: (B, S, S, 96) bf16 -> (B, S, S, c_exp) bf16.
TPURPN_EXPORT int ir_expand(const void* x, void* out, const void* we, const float* be,
                            int B, int S, int c_in, int c_exp, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || S > kMaxS || c_in != 96 || c_exp % NC != 0)
    return cudaErrorInvalidValue;
  auto kernel = ir_expand_kernel<96>;
  const size_t smem = 4 * (size_t)(P_MAX + NC) * (96 / 2 + 4);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + R - 1) / R, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(we), be, S, c_exp);
  return cudaGetLastError();
}

TPURPN_EXPORT const char* ir_stage_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
