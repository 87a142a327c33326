// ViTDet's attention core for Hopper (sm_90a): flash attention whose
// decomposed relative-position bias is made and added inside the kernel,
//
//   out = softmax(q k^T / sqrt(d) + rel_h[q, k_row] + rel_w[q, k_col]) v,
//   rel_h[q, k] = q . R_h[i - k + s - 1],  rel_w[q, l] = q . R_w[j - l + s - 1],
//
// over the unscaled q, for a query (i, j) and a key (k, l) of a side x side
// grid (s = side, T = s^2 tokens, 2s - 1 rows a table). The wrapper
// (tpurpn_torch/kernels/relpos_attention.py) launches it once for each of
// ViTDet-B's 12 attention cores a batch (backbones/vit.py).
//
// Replaces no TPU kernel: the JAX package has no ViT. On the card the same
// core was a (N, h, T, T) bias written to device memory by one product with
// a 0/1 expansion matrix, then cuDNN's SDPA reading it back: 6.4 GB a global
// block at B = 16.
//
// What bounds it: operations. At B = 16 the 4 global cores (T = 4,096, 12
// heads of d = 64) are 3.3 TFLOP of q k^T and p v, 3.39 ms at the bf16 peak
// (portbench/counts_levels.global_attn_bound); they read q, k and v and
// write the output once, 0.6 GB. The 8 window cores (400 windows of 196
// tokens) are ~0.4 ms of operations. With d = 64 each score costs as much
// exp and f32 work as tensor-core work, so the design keeps the tensor
// cores fed while the softmax runs beside them:
//
// * A block is two consumer warpgroups of 64 query slots each (sharing
//   every K/V tile) and one producer warpgroup, persistent over work items
//   (two query tiles of one head of one image). One producer thread brings
//   each item's q tiles (two buffers) and K and V tiles of 128 keys by TMA
//   (tensor maps over q, k and v by their strides: the qkv Linear's (N, T,
//   3, h, d) output is read in place) into a ring of STAGES stages,
//   128-byte swizzled, under full/empty mbarriers, running ahead across
//   items. The producer gives its registers to the consumers (setmaxnreg).
// * Tiles are rectangles of the token grid: C columns (the least of 8, 16,
//   32, 64 that holds a grid row) by 64 / C rows for queries and 128 / C
//   for keys (5-D tensor maps; slots off the grid read zero). At side 64 (a
//   global block) a q tile is one grid row and a key tile two; at side 14
//   (a window) 16 x 4 and 16 x 8.
// * A consumer computes S = q K^T (64 x 128) with wgmma (q's fragments in
//   registers, loaded once an item; K from shared memory), then, while the tensor
//   cores run O += P V of the tile before (P from registers, V an MN-major
//   operand), the online softmax of this tile in f32 with 1/sqrt(d) and
//   log2(e) folded into one FMA and exp2; O is rescaled once that product
//   has landed, and only where the max moved (FlashAttention-3's
//   intra-warpgroup overlap). The two warpgroups take turns on the tensor
//   cores (named barriers): one's products run while the other's softmax
//   does.
// * The bias never leaves the SM. For each item a warpgroup computes its
//   queries' products with the tables, E_w = q R_w^T and E_h = q R_h^T, by
//   wgmma into f32 in shared memory (the f32 tables, held in bf16 once a
//   block, rounded as the materialised bias rounded them). Within a key
//   tile the key column of each fragment column is fixed, so rel_w is one
//   register a score for the whole item (-inf on the columns off the grid,
//   which masks them); the key row changes every C columns, so rel_h is
//   128 / C shared-memory reads a query row a tile, each added to its key
//   row's partial max and to the exponent's offset, not to each score.
// * A window block's pad tokens (its zero-padded tokens) are keys like any
//   other; only the slots off the grid are masked (-inf), and query slots
//   off the grid are computed on zeros and not stored. The output is
//   written as (N, T, h, d), so proj's reshape of it is a view.
//
// Numerics: bf16 q, k, v and tables; f32 scores, bias, softmax and sums; P
// rounded to bf16 for the P V product (as every flash kernel, cuDNN's
// included); bf16 output. A barrier that never completes ends the launch
// with a trap after ~5 s instead of hanging the card.

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is looked up at run time)
#include <dlfcn.h>

#include "wgmma.cuh"

namespace {

constexpr int D = 64;                    // head width the kernel computes in
constexpr int BM = 64;                   // query rows a warpgroup
constexpr int WGS = 2;                   // consumer warpgroups a block
constexpr int BN = 128;                  // keys a tile
constexpr int STAGES = 3;                // K/V tiles in flight
constexpr int kThreads = WGS * 128 + 128;  // + the producer warpgroup
constexpr int TILE = BM * D * 2;         // bytes of a q tile (64 x 64 bf16)
constexpr int KV_TILE = BN * D * 2;      // bytes of a K or V tile
constexpr int RROWS = 128;               // table rows held (2 side - 1 <= 127)
constexpr int ESTRIDE = 65;              // f32 words a row of an E table
constexpr int E_WORDS = 64 * ESTRIDE;    // f32 words of a warpgroup's E table
constexpr int kAlign = 1024;             // the 128-byte swizzle repeats every 1 KB

constexpr int OFF_Q = 0;                            // 2 x WGS q tiles (two items)
constexpr int OFF_KV = OFF_Q + 2 * WGS * TILE;      // STAGES x (K tile, V tile)
constexpr int OFF_RW = OFF_KV + STAGES * 2 * KV_TILE;  // R_w, RROWS rows
constexpr int OFF_RH = OFF_RW + RROWS * 128;        // R_h, RROWS rows
constexpr int OFF_E = OFF_RH + RROWS * 128;         // f32 E table, E_WORDS a warpgroup
constexpr int OFF_BAR = OFF_E + WGS * E_WORDS * 4;  // full, empty [STAGES]; q full, empty [2]
constexpr int SMEM = kAlign + OFF_BAR + (2 * STAGES + 4) * 8;
static_assert(SMEM <= 232448, "shared memory");

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// wgmma descriptor of a 128-byte-swizzled operand: rows of 128 bytes (64
// bf16), 8-row groups 1,024 bytes apart (SBO), layout type 1. K-major (q,
// K, the tables) a K step of 16 adds 32 bytes; MN-major (V: keys are K,
// its 64 columns one swizzle atom, so LBO is unused) a K step adds 2,048.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers: a[r] holds row g + 8 (r & 1),
// columns 2 (t % 4) + 8 (r >> 1) + {0, 1} of the warp's 16 rows, as S's
// accumulator lays them out) * B (16 x 64 bf16, MN-major in shared memory).
__device__ __forceinline__ void mma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 f32) = (accumulate ? d : 0) + A (64 x 16 bf16, registers, as
// for mma_rs_mn) * B (16 x 128 bf16, K-major in shared memory).
__device__ __forceinline__ void mma_rs_k128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void fence_words(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Ping-pong of the two consumer warpgroups on the tensor cores: a
// warpgroup starts its products of a tile in its turn (turn_wait), then
// hands the turn to the other (turn_pass) and runs its softmax while the
// other's products run. Named barriers 4 and 5, 256 threads each.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(4 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(5 - wg) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity; a phase
// that does not complete within ~2^33 cycles traps.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 33)) __trap();
  }
}

// A box of a 5-D tensor map (d, grid column, grid row, h, N) of bf16: the
// 64 d of grid columns [0, C) of the box's grid rows from `row` on, of head
// `head` of image n, into 128-byte-swizzled rows at dst, token slot col + C
// * (grid row - row); slots off the grid read zero. Completes on `bar`.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, int row, int head,
                                         int n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(0), "r"(row), "r"(head), "r"(n),
      "r"(smem_u32(bar))
      : "memory");
}

// The first `rows` rows of a (valid, 64) f32 table, rounded to bf16, into
// dst (128-byte rows, 128-byte swizzle); rows at or past `valid` are zero.
// Thread `t` of `threads`.
__device__ __forceinline__ void load_table(unsigned char* dst, const float* __restrict__ src,
                                           int rows, int valid, int t, int threads) {
  for (int i = t; i < rows * 8; i += threads) {
    const int m = i >> 3, c = i & 7;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (m < valid) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src + m * D + 8 * c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(src + m * D + 8 * c + 4));
      w = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                     pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(dst + m * 128 + ((c ^ (m & 7)) << 4)) = w;
  }
}

// acc (this warpgroup's 64 queries x 64 table rows) = q R^T over d = 64.
__device__ __forceinline__ void table_product(float (&acc)[32], uint64_t dq, uint64_t dr) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) wgmma_bf16(acc, dq + 2 * ks, dr + 2 * ks);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// Store a 64 x 64 accumulator, times log2(e), at E[row * ESTRIDE + col - shift]
// for the columns with 0 <= col - shift < 64.
__device__ __forceinline__ void store_e(float* E, const float (&acc)[32], int shift, int row0,
                                        int cq) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * cq + e - shift;
        if (c >= 0 && c < 64) E[(row0 + 8 * h) * ESTRIDE + c] = acc[4 * j + 2 * h + e] * LOG2E;
      }
}

// bf16(lo) | bf16(hi) << 16, one instruction.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// S (64 x 128 f32) = q K^T over d = 64: qa q's fragments, dk the K tile's
// descriptor. Committed, not waited for.
__device__ __forceinline__ void start_s(float (&s)[64], const uint32_t (&qa)[16], uint64_t dk) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t a[4] = {qa[4 * ks], qa[4 * ks + 1], qa[4 * ks + 2], qa[4 * ks + 3]};
    mma_rs_k128(s, a, dk + 2 * ks, ks > 0);
  }
  wgmma_commit();
}

// The warpgroup's q tile (64 x 64 bf16, 128-byte swizzled at qs) as A
// fragments: register 4 ks + r of k step ks, as mma_rs_k128 takes them.
__device__ __forceinline__ void load_q(uint32_t (&qa)[16], const unsigned char* qs, int row0,
                                       int cq) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r & 1), chunk = 2 * ks + (r >> 1);
      qa[4 * ks + r] =
          *reinterpret_cast<const uint32_t*>(qs + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * cq);
    }
}

// O += P V over the tile's 128 keys: dv the V tile's descriptor. Committed,
// not waited for.
__device__ __forceinline__ void start_pv(float (&o)[32], const uint32_t (&p)[32], uint64_t dv) {
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) {
    const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3]};
    mma_rs_mn(o, a, dv + (2048 >> 4) * ks);
  }
  wgmma_commit();
}

// P (bf16) as the A operand of P V: register 4 ks + r of k step ks.
__device__ __forceinline__ void pack_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[4 * ks + r] = pack2(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
}

// Key tile kt's raw scores q . k in s -> its probabilities, exp2 of the
// log2-scaled logits less the running max m, and the per-thread sums l;
// alpha: the factor that the sums and O before this tile take (1 exactly
// where the tile does not raise the max). rw: rel_w of the thread's key
// columns (-inf where a column is off the grid), the same for every tile;
// rb[h][k]: rel_h of row h at the tile's key row k (-inf off the grid).
// Every term is already times log2(e).
template <int C>
__device__ __forceinline__ void tile_softmax(float (&s)[64], const float (&rw)[32],
                                             const float (&rb)[2][BN / C], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2) {
  constexpr int JR = C / 8, KR = BN / C;  // fragment column groups a key row; key rows a tile
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)  // key columns repeat every 64 (C divides 64)
      s[4 * j + i] = __fmaf_rn(s[4 * j + i], scale_log2, rw[4 * (j % 8) + i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      float mk = -INFINITY;
#pragma unroll
      for (int j = k * JR; j < (k + 1) * JR; ++j)
        mk = fmaxf(mk, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, mk + rb[h][k]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    alpha[h] = ex2(m[h] - m_new);  // 1 exactly where the max holds
    m[h] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const float off = rb[h][k] - m_new;
#pragma unroll
      for (int j = k * JR; j < (k + 1) * JR; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = ex2(s[4 * j + 2 * h + e] + off);
          s[4 * j + 2 * h + e] = pr;
          sum += pr;
        }
    }
    l[h] = l[h] * alpha[h] + sum;
  }
}

// rb[h][k] = rel_h of row h at key tile kt's key row k, from E_h' (eh[h]:
// the row's entry at key row 0); -inf past the grid.
template <int R>
__device__ __forceinline__ void rel_rows(float (&rb)[2][R], const float* const (&eh)[2], int kt,
                                         int side) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int kr = kt * R + k;
      rb[h][k] = kr < side ? eh[h][-kr] : -INFINITY;
    }
}

// A q tile is C grid columns by R = 64 / C grid rows of the side x side grid
// (C: the least of 8, 16, 32, 64 that holds a row), a key tile C by KR =
// 128 / C. Within a key tile, the key column of a fragment column is fixed,
// so rel_w is a register a score for the whole work item, and the key row
// changes every C columns, so rel_h is KR numbers a row a tile. Persistent:
// block b takes the work items b, b + gridDim.x, ... (item: 2 q tiles of
// one head of one image); the producer runs ahead across items.
template <int C>
__global__ void __launch_bounds__(kThreads, 1) relpos_attention_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w, int N, int side,
    int heads, float scale_log2) {
  constexpr int R = 64 / C;                 // grid rows a q tile
  constexpr int CHUNKS = C == 64 ? 2 : 1;   // 64-row chunks of a table (2 side - 1 rows)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + OFF_BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int KR = BN / C;                // grid rows a key tile
  const int T = side * side, nk = (side + KR - 1) / KR;  // tokens; key tiles a grid
  const int nqb = ((side + R - 1) / R + WGS - 1) / WGS, items = nqb * heads * N;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS * 4);  // lane 0 of every consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&qempty[b], WGS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= WGS * 4) {  // the producer: each item's q tiles, then its K/V tiles
    // its registers go to the consumers (40 + 2 x 232 a thread of each SM
    // partition's 3 warps fit its 16K registers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == WGS * 4 && lane == 0) {
      int tg = 0;  // K/V tiles loaded over all items
      for (int it = blockIdx.x, qi = 0; it < items; it += gridDim.x, ++qi) {
        const int qb = it % nqb, head = (it / nqb) % heads, n = it / (nqb * heads);
        const int b = qi & 1;
        if (qi >= 2) mbar_wait(&qempty[b], ((qi >> 1) + 1) & 1);
        mbar_expect(&qfull[b], WGS * TILE);
        for (int w = 0; w < WGS; ++w)
          tma_tile(base + OFF_Q + (b * WGS + w) * TILE, &qmap, (qb * WGS + w) * R, head, n,
                   &qfull[b]);
        for (int t = 0; t < nk; ++t, ++tg) {
          const int s = tg % STAGES;
          if (tg >= STAGES) mbar_wait(&empty[s], ((tg / STAGES) + 1) & 1);
          unsigned char* kv = base + OFF_KV + s * 2 * KV_TILE;
          mbar_expect(&full[s], 2 * KV_TILE);
          tma_tile(kv, &kmap, t * KR, head, n, &full[s]);
          tma_tile(kv + KV_TILE, &vmap, t * KR, head, n, &full[s]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid >> 7, wi = warp & 3, g = lane >> 2, cq = lane & 3;
  const int row0 = 16 * wi + g;  // this thread's query slots of a tile: row0, row0 + 8

  // the tables in bf16, once
  const int valid = 2 * side - 1;
  load_table(base + OFF_RW, rel_w, 64 * CHUNKS, valid, tid, WGS * 128);
  load_table(base + OFF_RH, rel_h, 64 * CHUNKS, valid, tid, WGS * 128);
  fence_proxy_async();
  bar_sync(1, WGS * 128);

  float* E = reinterpret_cast<float*>(base + OFF_E) + wg * E_WORDS;
  const uint64_t drw = desc_sw128(smem_u32(base + OFF_RW));
  const uint64_t drh = desc_sw128(smem_u32(base + OFF_RH));
  const uint64_t dkv = desc_sw128(smem_u32(base + OFF_KV));
  constexpr int STAGE_DESC = (2 * KV_TILE) >> 4, V_DESC = KV_TILE >> 4, ROWS64 = (64 * 128) >> 4;
  float rw[32];  // rel_w * log2(e) of the thread's key columns, S's layout
  float acc[32], s[64], o[32];
  uint32_t p[32], qa[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) rw[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.0f;

  if (wg == 1) turn_pass(1);  // the first warpgroup takes the first turn
  int tg = 0;  // K/V tiles consumed over all items
  for (int it = blockIdx.x, qi = 0; it < items; it += gridDim.x, ++qi, tg += nk) {
    const int qb = it % nqb, head = (it / nqb) % heads, n = it / (nqb * heads);
    const int i0 = (qb * WGS + wg) * R;  // the warpgroup's first grid row
    const int b = qi & 1;
    mbar_wait(&qfull[b], (qi >> 1) & 1);
    const unsigned char* qs = base + OFF_Q + (b * WGS + wg) * TILE;
    const uint64_t dq = desc_sw128(smem_u32(qs));
    load_q(qa, qs, row0, cq);
    bar_sync(2 + wg, 128);  // the warpgroup is done with the last item's E

    // rel_w[q, l] = q . R_w[j - l + side - 1] (j: q's grid column), from
    // E_w = q R_w^T in 64-column chunks
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      table_product(acc, dq, drw + c * ROWS64);
      if (c) bar_sync(2 + wg, 128);
      store_e(E, acc, 0, row0, cq);
      bar_sync(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = row0 + 8 * h, kc = (8 * j + 2 * cq + e) % C;
            const int x = r % C - kc + side - 1;
            if (kc >= side)
              rw[4 * j + 2 * h + e] = -INFINITY;
            else if ((x >> 6) == c)
              rw[4 * j + 2 * h + e] = E[r * ESTRIDE + (x & 63)];
          }
    }
    bar_sync(2 + wg, 128);
    // E_h'[q, m] = q . R_h[i0 + m]: rel_h of q (grid row i) at key row k is
    // column i - i0 - k + side - 1
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      table_product(acc, dq, drh + c * ROWS64);
      store_e(E, acc, i0 - 64 * c, row0, cq);
    }
    bar_sync(2 + wg, 128);
    const float* eh[2];  // row h's E_h' entry at key row 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      eh[h] = E + r * ESTRIDE + r / C + side - 1;
    }

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2], rb[2][KR];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    rel_rows(rb, eh, 0, side);
    mbar_wait(&full[tg % STAGES], (tg / STAGES) & 1);
    turn_wait(wg);
    wgmma_fence();
    start_s(s, qa, dkv + (tg % STAGES) * STAGE_DESC);
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    fence_words(qa);
    tile_softmax<C>(s, rw, rb, m, l, alpha, scale_log2);
    pack_p(p, s);
    for (int kt = 1; kt < nk; ++kt) {
      const int st = (tg + kt) % STAGES, sp = (tg + kt - 1) % STAGES;
      rel_rows(rb, eh, kt, side);
      mbar_wait(&full[st], ((tg + kt) / STAGES) & 1);
      turn_wait(wg);
      wgmma_fence();
      start_s(s, qa, dkv + st * STAGE_DESC);
      start_pv(o, p, dkv + sp * STAGE_DESC + V_DESC);
      turn_pass(wg);
      wgmma_wait<1>();
      fence_regs(s);
      fence_words(qa);
      tile_softmax<C>(s, rw, rb, m, l, alpha, scale_log2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_words(p);
      if (lane == 0) mbar_arrive(&empty[sp]);
      __syncwarp();
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
      pack_p(p, s);
    }
    const int sl = (tg + nk - 1) % STAGES;
    turn_wait(wg);
    wgmma_fence();
    start_pv(o, p, dkv + sl * STAGE_DESC + V_DESC);
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(o);
    fence_words(p);
    if (lane == 0) {  // the item's q tile and last K/V tile are free
      mbar_arrive(&empty[sl]);
      mbar_arrive(&qempty[b]);
    }
    __syncwarp();

    // normalise and store the slots on the grid, (N, T, heads, 64)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tot = l[h];
      tot += __shfl_xor_sync(0xffffffffu, tot, 1);
      tot += __shfl_xor_sync(0xffffffffu, tot, 2);
      const float inv = 1.0f / tot;
      const int r = row0 + 8 * h, i = i0 + r / C, j = r % C;
      if (i < side && j < side) {
        __nv_bfloat16* row = out + ((size_t)((size_t)n * T + i * side + j) * heads + head) * D;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint32_t*>(row + 8 * jj + 2 * cq) =
              pack2(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has loaded:
// looked up, so that the library links against nothing beyond the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The (d, grid column, grid row, h, N) map of one of q, k, v: element
// strides st (token), sh (head), sn (image); boxes of 64 d x C columns x
// 64 / C rows, 128-byte swizzled.
bool tensor_map(CUtensorMap* map, const void* ptr, int N, int heads, int side, int C, int rows,
                long long st, long long sh, long long sn) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)side, (cuuint64_t)side,
                              (cuuint64_t)heads, (cuuint64_t)N};
  const cuuint64_t strides[4] = {(cuuint64_t)st * 2, (cuuint64_t)st * side * 2,
                                 (cuuint64_t)sh * 2, (cuuint64_t)sn * 2};
  const cuuint32_t box[5] = {(cuuint32_t)D, (cuuint32_t)C, (cuuint32_t)(rows / C), 1, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <int C>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   void* out, const float* rel_h, const float* rel_w, int N, int heads,
                   int side, float scale_log2, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};  // blocks the card holds at once
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(relpos_attention_kernel<C>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, relpos_attention_kernel<C>, kThreads, SMEM)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
  }
  const int tiles = (side + 64 / C - 1) / (64 / C);
  const long long items = (long long)((tiles + WGS - 1) / WGS) * heads * N;
  const int blocks = (int)(items < resident[device] ? items : resident[device]);
  relpos_attention_kernel<C><<<blocks, kThreads, SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), rel_h, rel_w, N, side, heads, scale_log2);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One attention core: q, k, v (N, heads, T = side^2, 64) bf16 with the same
// element strides st (token), sh (head), sn (image), each a multiple of 8,
// and unit stride along d; rel_h, rel_w (2 side - 1, 64) f32 contiguous;
// out (N, T, heads, 64) bf16 contiguous. scale_log2 = log2(e) / sqrt(d).
// side 1 to 64; N and heads at least 1.
TPURPN_EXPORT int relpos_attention(const void* q, const void* k, const void* v, void* out,
                                   const float* rel_h, const float* rel_w, int N, int heads,
                                   int side, int st, int sh, int sn, float scale_log2,
                                   cudaStream_t stream) {
  if (N <= 0 || heads <= 0 || side <= 0 || side > 64 || st <= 0 || sh <= 0 || sn <= 0 ||
      st % 8 || sh % 8 || sn % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out) || !aligned16(rel_h) || !aligned16(rel_w))
    return cudaErrorInvalidValue;
  const int C = side <= 8 ? 8 : side <= 16 ? 16 : side <= 32 ? 32 : 64;
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, N, heads, side, C, BM, st, sh, sn) ||
      !tensor_map(&km, k, N, heads, side, C, BN, st, sh, sn) ||
      !tensor_map(&vm, v, N, heads, side, C, BN, st, sh, sn))
    return cudaErrorInvalidValue;
#define TPURPN_RPA(CC) \
  if (C == CC) return launch<CC>(qm, km, vm, out, rel_h, rel_w, N, heads, side, scale_log2, stream);
  TPURPN_RPA(8)
  TPURPN_RPA(16)
  TPURPN_RPA(32)
  TPURPN_RPA(64)
#undef TPURPN_RPA
  return cudaErrorInvalidValue;
}

TPURPN_EXPORT const char* relpos_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
