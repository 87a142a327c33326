// Swin's shifted-window attention core for Hopper (sm_90a), reading the
// block's qkv product in grid order: for each image, each 7 x 7 window of
// the rolled, zero-padded (Hp, Wp) grid and each head of d = 32,
//
//   out = softmax(q k^T d^-0.5 + B[h] + mask) v,   B[h][a, b] = table[index(a, b), h],
//
// index(a, b) = (ya - yb + 6) 13 + (xa - xb + 6) for window positions a and
// b, mask -100 between positions whose region labels differ (shifted
// blocks, where `masked` is set). Window token (wy 7 + ay, wx 7 + ax) of
// the rolled grid is the token ((y + s) mod Hp, (x + s) mod Wp) of the
// unrolled one; a token off the (H, W) grid is a pad token, whose k and v
// are the qkv Linear's bias (the product of a zero token) and whose output
// is dropped. Each output row goes to its token's unrolled grid position of
// the (B, H, W, C) output: every grid token lies in one window, so no two
// stores meet. The wrapper (tpurpn_torch/kernels/swin_attention.py)
// launches it once a block of the backbone, 24 times a forward of Swin-B;
// tpurpn_torch/backbones/swin.py calls it.
//
// Replaces no TPU kernel: the JAX package has no Swin. On the card the same
// core was a pad and a gather of the block's tokens into window order, the
// qkv product on the windows, cuDNN's SDPA reading a materialised bias (in a
// shifted block the bias plus the mask, expanded over the images: up to
// 454 MB a block at B = 16), and a gather back to the grid.
//
// What bounds it: bytes. At B = 16 on Swin-B's 800 x 1088 canvas the 24
// cores read q, k and v and write the output once, 7.66 GB counted over the
// padded grids (portbench/counts_swin.attn_bound: 2.29 ms at 3.35 TB/s; the
// unpadded grids the kernel reads are 6.91 GB). One (window, head) moves
// 12.5 KB for 0.31 MFLOP, about 25 operations a byte against the 295 at
// which the tensor cores would set the pace, so the design streams the
// product at HBM rate and keeps the arithmetic off the critical path:
//
// * The unit of traffic is a window's tokens for a group of 4 heads (an
//   item: image, window, head group; the head group fastest, so that the
//   blocks in flight read neighbouring slices of the same tokens). Each of
//   q, k and v of a token and group is a 256-byte run of the product; 7
//   neighbouring tokens of a window row are neighbouring runs but where the
//   window wraps or leaves the grid. A persistent block of 8 warps stages
//   an item's 49 x 3 runs into shared memory by cp.async, 16 bytes a
//   thread (a pad token's k and v from the bias, its q as zeros), two
//   items deep: the next item's copies are in flight while this one
//   computes. Rows are 16-byte chunks XOR-swizzled by the token's low
//   bits, so every ldmatrix below is free of bank conflicts.
// * Two warps a head, two 16-row m-tiles each (49 queries in 64 rows; rows
//   and keys past 49 read a zero row): S = q k^T over 56 keys (7 n-tiles)
//   at depth 32 and O = P V over 64 keys by bf16 mma.sync (m16n8k16), the
//   fragments by ldmatrix (V's transposed); the softmax in registers over
//   the whole window at once (no online rescaling). The bias is the f32
//   table (169 x heads, in shared memory a launch) read at base(a) -
//   key(b): one shared load a score. The mask is a compare of two region
//   labels a score, in the last row and column of windows only (the
//   others lie in one region).
// * The output rows, normalised and rounded once to bf16, are written over
//   the item's q in shared memory, then stored as the same 256-byte runs
//   of the (B, H, W, C) output, 16 bytes a thread.
//
// Numerics: bf16 q, k, v; f32 scores, bias, mask and softmax (exp2 of the
// log2-scaled logits); P rounded to bf16 for P V; f32 sums; one rounding
// of the output to bf16.

#include "wgmma.cuh"

namespace {

constexpr int M = 7, T = M * M;             // window side, tokens a window
constexpr int D = 32;                       // head width
constexpr int G = 4;                        // heads an item
constexpr int ROW = G * D * 2;              // bytes of a token's q, k or v of G heads: 256
constexpr int CHUNKS = ROW / 16;            // 16-byte chunks of a row
constexpr int TENSOR = T * ROW;             // a staged q, k or v: 12,544 bytes
constexpr int STAGE = 3 * TENSOR;           // an item's q, k and v
constexpr int MAX_HEADS = 32;
constexpr int TROWS = (2 * M - 1) * (2 * M - 1);  // 169 table rows
constexpr int kThreads = 256;               // 8 warps: 2 a head of the group
constexpr int OFF_ZERO = 0;                 // a zero row (256 bytes)
constexpr int OFF_TABLE = OFF_ZERO + ROW;   // f32 table, head-major
constexpr int OFF_STAGE = OFF_TABLE + MAX_HEADS * TROWS * 4;
constexpr int SMEM = OFF_STAGE + 2 * STAGE;
static_assert(OFF_STAGE % 16 == 0 && STAGE % 16 == 0, "16-byte rows");
static_assert(2 * (SMEM + 1024) <= 233472, "two blocks an SM");
constexpr int kMaxDevices = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK = -100.0f;

struct Args {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* bias;  // (3 C) the qkv Linear's bias
  const float* table;         // (169, heads) f32
  __nv_bfloat16* out;         // (B, H, W, C)
  int H, W, Hp, Wp, nh, nw, nwin;
  int sb, sh, sw;             // element strides of image, row, column
  int C, heads, groups, shift, masked, items;
  float scale;
};

struct Item {
  int b, wy, wx, g;
};

__device__ __forceinline__ Item decode(const Args& a, int n) {
  Item it;
  it.g = n % a.groups;
  const int r = n / a.groups, win = r % a.nwin;
  it.b = r / a.nwin;
  it.wy = win / a.nw;
  it.wx = win - it.wy * a.nw;
  return it;
}

// Window token t's source on the unrolled grid; false for a pad token.
__device__ __forceinline__ bool source(const Args& a, const Item& it, int t, int& sy, int& sx) {
  const int ay = t / M, ax = t - ay * M;
  sy = it.wy * M + ay + a.shift;
  sx = it.wx * M + ax + a.shift;
  if (sy >= a.Hp) sy -= a.Hp;
  if (sx >= a.Wp) sx -= a.Wp;
  return sy < a.H && sx < a.W;
}

// Byte offset of chunk c of token row t in a staged tensor.
__device__ __forceinline__ int chunk_at(int t, int c) { return t * ROW + ((c ^ (t & 7)) << 4); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of item n's q, k and v into `buf` (this thread's share);
// a pad token's chunks are stored directly.
__device__ __forceinline__ void stage(const Args& a, int n, unsigned char* buf) {
  const Item it = decode(a, n);
  const __nv_bfloat16* img = a.qkv + (size_t)it.b * a.sb + it.g * (G * D);
  const __nv_bfloat16* bias = a.bias + it.g * (G * D);
  for (int i = threadIdx.x; i < T * 3 * CHUNKS; i += kThreads) {
    const int t = i / (3 * CHUNKS), r = i - t * (3 * CHUNKS), w = r / CHUNKS, c = r % CHUNKS;
    if (it.g * G + c / 4 >= a.heads) continue;  // past the last head
    int sy, sx;
    unsigned char* dst = buf + w * TENSOR + chunk_at(t, c);
    if (source(a, it, t, sy, sx)) {
      cp_async16(dst, img + (size_t)sy * a.sh + (size_t)sx * a.sw + w * a.C + c * 8);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (w) v = __ldg(reinterpret_cast<const uint4*>(bias + w * a.C + c * 8));
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d (16 x 8 f32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16(lo) | bf16(hi) << 16, round to nearest even.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Region label of rolled row (or column) r of a padded side n: Swin's slices
// [0, n - 7), [n - 7, n - s), [n - s, n).
__device__ __forceinline__ int region(int r, int n, int s) {
  return (r >= n - M) + (r >= n - s);
}

// Address of chunk c of row `row` of the staged tensor at `base`, the zero
// row past the window's 49 tokens.
__device__ __forceinline__ uint32_t row_addr(uint32_t base, uint32_t zero, int row, int c) {
  return row < T ? base + chunk_at(row, c) : zero + (c << 4);
}

// One head's 16 queries from row m0 of the staged item at `buf`: scores,
// softmax and the product with V; the normalised rows written over q.
// kb[j]: the table offset 13 by + bx of this thread's key column j (nt 8 +
// 2 q4 + e, j = 2 nt + e; past the 49 keys that of key 48).
__device__ __forceinline__ void m_tile(const Args& a, const Item& it, unsigned char* buf,
                                       uint32_t zero, const float* tb, int hl, int m0,
                                       const int (&kb)[14], bool need_mask) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q4 = lane & 3;
  const uint32_t qs = smem_u32(buf), ks = qs + TENSOR, vs = qs + 2 * TENSOR;

  uint32_t qa[2][4];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    ldsm_x4(qa[k], row_addr(qs, zero, m0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            hl * 4 + 2 * k + (lane >> 4)));
  float s[7][4];
#pragma unroll
  for (int nt = 0; nt < 7; ++nt) {
    uint32_t kf[4];
    ldsm_x4(kf, row_addr(ks, zero, nt * 8 + (lane & 7), hl * 4 + (lane >> 3)));
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    mma(s[nt], qa[0], kf[0], kf[1]);
    mma(s[nt], qa[1], kf[2], kf[3]);
  }

  // logits: scale, the table's bias, the mask; keys past 49 at -inf
  int base[2], lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = min(m0 + gq + 8 * h, T - 1), ry = r / M, rx = r - ry * M;
    base[h] = ry * 13 + rx + 84;
    lab[h] = region(it.wy * M + ry, a.Hp, a.shift) * 3 + region(it.wx * M + rx, a.Wp, a.shift);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 7; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * nt + e;
      const bool valid = nt < 6 || 2 * q4 + e == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = -INFINITY;
        if (valid) {
          x = fmaf(s[nt][2 * h + e], a.scale, tb[base[h] - kb[j]]);
          if (need_mask) {
            const int cy = kb[j] / 13, cx = kb[j] - cy * 13;
            const int lc = region(it.wy * M + cy, a.Hp, a.shift) * 3 +
                           region(it.wx * M + cx, a.Wp, a.shift);
            if (lc != lab[h]) x += MASK;
          }
        }
        s[nt][2 * h + e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float off = -mx[h] * LOG2E;
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[nt][2 * h + e], LOG2E, off));
        s[nt][2 * h + e] = p;
        sum[h] += p;
      }
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }

  // O = P V over keys 0-63 (P zero past 56, V's rows past 49 the zero row)
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack2(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack2(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = kk < 3 ? pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]) : 0u;
    pa[3] = kk < 3 ? pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]) : 0u;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t vf[4];
      ldsm_x4_t(vf, row_addr(vs, zero, 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                             hl * 4 + 2 * j + (lane >> 4)));
      mma(o[2 * j], pa, vf[0], vf[1]);
      mma(o[2 * j + 1], pa, vf[2], vf[3]);
    }
  }

  // normalise, round once, write over this head's q of the rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + gq + 8 * h;
    if (r >= T) continue;
    const float inv = 1.0f / sum[h];
#pragma unroll
    for (int dn = 0; dn < 4; ++dn)
      *reinterpret_cast<uint32_t*>(buf + chunk_at(r, hl * 4 + dn) + 4 * q4) =
          pack2(o[dn][2 * h] * inv, o[dn][2 * h + 1] * inv);
  }
}

// Persistent: block k takes items k, k + gridDim.x, ...
__global__ void __launch_bounds__(kThreads, 2) swin_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* table = reinterpret_cast<float*>(smem + OFF_TABLE);
  unsigned char* stages = smem + OFF_STAGE;
  for (int i = threadIdx.x; i < ROW / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(smem + OFF_ZERO)[i] = 0u;
  for (int i = threadIdx.x; i < TROWS * a.heads; i += kThreads) {
    const int r = i / a.heads, h = i - r * a.heads;  // coalesced reads of (169, heads)
    table[h * TROWS + r] = a.table[i];
  }
  const uint32_t zero = smem_u32(smem + OFF_ZERO);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int hl = warp & 3, mt0 = 2 * (warp >> 2);  // the warp's head of the group, first m-tile
  int kb[14];  // table offsets of this thread's key columns
#pragma unroll
  for (int nt = 0; nt < 7; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = min(nt * 8 + 2 * q4 + e, T - 1), by = b / M;
      kb[2 * nt + e] = by * 13 + (b - by * M);
    }

  int n = blockIdx.x;
  if (n < a.items) stage(a, n, stages);
  cp_async_commit();
  for (int k = 0; n < a.items; ++k, n += gridDim.x) {
    unsigned char* buf = stages + (k & 1) * STAGE;
    if (n + (int)gridDim.x < a.items) stage(a, n + gridDim.x, stages + ((k + 1) & 1) * STAGE);
    cp_async_commit();
    cp_async_wait<1>();  // this item's copies (all but the group just committed) have landed
    __syncthreads();
    const Item it = decode(a, n);
    const int head = it.g * G + hl;
    if (head < a.heads) {
      const bool need_mask = a.masked && (it.wy == a.nh - 1 || it.wx == a.nw - 1);
      const float* tb = table + head * TROWS;
      m_tile(a, it, buf, zero, tb, hl, 16 * mt0, kb, need_mask);
      m_tile(a, it, buf, zero, tb, hl, 16 * mt0 + 16, kb, need_mask);
    }
    __syncthreads();  // every output row is in shared memory
    for (int i = threadIdx.x; i < T * CHUNKS; i += kThreads) {
      const int t = i / CHUNKS, c = i % CHUNKS;
      int sy, sx;
      if (it.g * G + c / 4 >= a.heads || !source(a, it, t, sy, sx)) continue;
      *reinterpret_cast<uint4*>(a.out + (((size_t)it.b * a.H + sy) * a.W + sx) * a.C +
                                it.g * (G * D) + c * 8) =
          *reinterpret_cast<const uint4*>(buf + chunk_at(t, c));
    }
    __syncthreads();  // the buffer is free for the item after next
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// As many blocks as stay resident on the device (found at the first call
// on it), at most one an item.
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(swin_attention_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, swin_attention_kernel,
                                                             kThreads, SMEM)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
  }
  const int blocks = a.items < resident[device] ? a.items : resident[device];
  swin_attention_kernel<<<blocks, kThreads, SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One Swin block's attention core: qkv (B, H, W, 3 C) bf16 with element
// strides (sb, sh, sw) of image, row and column, each a multiple of 8, and
// unit channel stride, C = heads * 32; bias (3 C) bf16 contiguous; table
// (169, heads) f32 contiguous; out (B, H, W, C) bf16 contiguous. Window 7,
// shift 0-6, 1-32 heads; masked: add the shift mask. scale = 32^-0.5.
TPURPN_EXPORT int swin_attention(const void* qkv, const void* bias, const float* table,
                                 void* out, int B, int H, int W, int sb, int sh, int sw,
                                 int heads, int shift, int masked, float scale,
                                 cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || heads <= 0 || heads > MAX_HEADS || shift < 0 ||
      shift >= M || sb <= 0 || sh <= 0 || sw <= 0 || sb % 8 || sh % 8 || sw % 8 ||
      !aligned16(qkv) || !aligned16(bias) || !aligned16(out) ||
      (reinterpret_cast<uintptr_t>(table) & 3))
    return cudaErrorInvalidValue;
  Args a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.table = table;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H, a.W = W;
  a.Hp = (H + M - 1) / M * M, a.Wp = (W + M - 1) / M * M;
  a.nh = a.Hp / M, a.nw = a.Wp / M, a.nwin = a.nh * a.nw;
  a.sb = sb, a.sh = sh, a.sw = sw;
  a.C = heads * D, a.heads = heads, a.groups = (heads + G - 1) / G;
  a.shift = shift, a.masked = masked != 0;
  a.scale = scale;
  const long long items = (long long)B * a.nwin * a.groups;
  if (items >= (1LL << 31)) return cudaErrorInvalidValue;
  a.items = (int)items;
  return launch(a, stream);
}

TPURPN_EXPORT const char* swin_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
