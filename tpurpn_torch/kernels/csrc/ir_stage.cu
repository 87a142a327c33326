// Fused MobileNetV2 inverted-residual blocks for Hopper (sm_90a).
//
// Replaces tpurpn/kernels/ir_stage_pallas.py::fused_ir_stage (body
// _ir_stage_kernel): stride-1 blocks at any S, for every spec
// pack_stage_weights builds up to the RPN tap (24 -> 24, block_2; 32 -> 32,
// blocks 4-5; 64 -> 64, blocks 7-9; 64 -> 96, block 10; 96 -> 96, blocks
// 11-12) and expand-only tails at c_in 24, 32, 64 or 96 (block_13_expand on
// the serving path, blocks 7-12 + block_13_expand: S = 32 at 500 px, 40 at
// 640). Each block is 1x1 expand -> ReLU6 -> 3x3 depthwise SAME -> ReLU6 ->
// 1x1 project (-> + residual); the tail is the 1x1 expand alone. The wrapper
// (tpurpn_torch/kernels/ir_stage.py) launches ir_block once per block and
// ir_expand once for the tail, all on one stream.
//
// Numerics, as the TPU kernel: the 1x1 convs take bf16 operands with f32
// accumulation; bias and ReLU6 in f32; the depthwise taps run in f32 over
// the f32 expanded activation; the result is rounded to bf16 after the
// depthwise ReLU6 and after the project bias; the residual add is a bf16 add.
// The library is built with -fmad=false (for the proposal kernel's exact
// IoU), so the depthwise's multiply-accumulates are explicit __fmaf_rn.
// dw_input_bf16 (tpurpn's option): the expanded activation is rounded to
// bf16 at its store and the taps to bf16; each tap product (exact in f32,
// two 8-bit significands) is rounded to bf16 and summed in f32 in tpurpn's
// tap order, without an FMA. c_exp_split (tpurpn's VMEM-footprint option)
// is not a kernel parameter: tpurpn sums one f32 partial projection per
// group of expanded channels, and this kernel sums every chunk into one f32
// accumulation, which differs from it by f32 summation order alone.
//
// What bounds it: at B=128, S=32 the serving stage is 127 GFLOP of 1x1
// products (0.129 ms at 989 TFLOP/s bf16) and 6.3 GFLOP of f32 depthwise
// taps (0.095 ms at 67 TFLOP/s), against about 168 MB of activation traffic
// (0.05 ms at 3.35 TB/s). The tensor cores and the f32 units run at the same
// time, so the bound is the larger: the tensor cores' operations, 0.129 ms;
// at S = 40 the work grows with the pixels (1600 / 1024): 0.201 ms.
//
// Design. A thread block (two warpgroups, 256 threads) takes R = 8 output
// rows of one image and the 10 input rows around them (the halo's expand is
// recomputed: 1.25x), laid out as 32 pixel slots a row, so 320 halo'd
// pixels are five 64-row M-tiles and 256 output pixels four. At S <= 32 slot
// j is image column j and columns -1 and S are the SAME padding. At S > 32
// the grid gains a column-strip axis: strip s of nstrips balanced strips
// outputs columns [s*sw, s*sw + sw) (sw <= 30) from slots 1..sw, and slot j
// holds image column s*sw - 1 + j, so the halo columns come from the
// neighbouring strip's image columns (their expand recomputed) or are the
// SAME zeros at the image's edge. A pixel's arithmetic (its K order in each
// 1x1 product and its 9-tap order) does not depend on where it falls. The
// serving instance at S <= 32 without dw_input_bf16 knows its one strip at
// compile time (kOne): with the strip read at run time the stage was slower
// on the card.
//
// The flat tiling (kFlat), for the S > 32 where it takes fewer blocks an
// image than strips (kernels/ir_stage.py: ir_block_plan; S = 40, 47, 63 of
// the 640-1000 px serving taps): a block outputs n consecutive pixels
// [f0, f0 + n) of the image in row-major order and stages the flat run
// [f0 - S - 1, f0 + n + S + 1), those pixels plus one image row and one
// pixel on each side, n + 2S + 2 <= 320 (S = 40: n = 229, 7 blocks an image
// against 10 in strips; 229 of its 320 staged pixels are outputs, against
// 160 of a strip's 320 slots). The input rows are flat (the expand's
// M-tiles are consecutive pixels), but the expand writes its f32 tile with
// one zero slot between image rows (pitch S + 1, kSlots slots): slot +- 1
// are the horizontal neighbours and the zero slot is the SAME padding of
// columns -1 and S, so the depthwise needs no mask; rows outside the image
// are zero in the run itself. The block's outputs span 3 image rows or more
// and are cut into at most 32 units of 8 columns of one row: the first
// row's from its first output, then for each k columns [8k, 8k + 8) of the
// other rows, down the rows; a unit that would pass its row's last output
// ends there instead, so every window lies in the staged run (with windows
// that could leave the tile behind a bounds check, the depthwise was
// markedly slower on the card). Unit u's outputs go to h2 rows
// 8u .. 8u + 7, so the depthwise stores at offsets known at compile time,
// and a table gives the epilogue each row's pixel. The 4 threads of a
// channel take 8 units each, as two streams of 4 walked side by side, fully
// unrolled, with the 3x10 window in registers as at S <= 32: a unit below
// the one before keeps two rows.
//
// The block walks the expanded channels in chunks of CH = 64:
//
//   1. expand: wgmma m64n32k16, A = the input rows in shared memory, B = the
//      chunk's expand weights; warpgroup g computes channels [32g, 32g + 32)
//      of the chunk at all 320 pixels; + bias, ReLU6, zero outside the image
//      (SAME padding) -> an f32 tile in shared memory;
//   2. depthwise from registers: a thread owns one channel and a strip of 8
//      slots and walks down the 8 rows with the 3x3 window in registers
//      (10 shared loads per 8 outputs, no division); the bf16 result goes
//      straight into the swizzled A operand of the projection;
//   3. project: wgmma m64n{C_OUT}k16, A = that tile, B = the chunk's project
//      weights; warpgroup g owns output M-tiles 2g and 2g + 1, and its
//      accumulators stay in registers across every chunk.
//
// Chunking is exact: the depthwise is per channel and the projection an f32
// sum over channels. Expanded activations never touch device memory. Two
// barriers a chunk. The expand starts tile mt + 1 before it stores tile mt,
// and the projection stays in flight across the next chunk's expand (its
// first wgmma wait retires it).
//
// Narrow specs: wgmma's K step is 16 channels and the operand planes are 32
// wide, so c_in = 24 is held as 32 (zero channels in the staged input, zero
// rows in the pack); c_exp = 144 is held as 192, three chunks, the pad
// channels with zero expand and project weights (and, read as zero here,
// biases and taps), so they stay 0 through ReLU6 and add nothing. c_out 24
// and 32 are wgmma widths (m64n24, m64n32).
//
// Weights: the wrapper packs each block once (cached) into per-chunk
// images of exactly the shared-memory layout below, [expand weights of the
// chunk | project weights of the chunk], contiguous. The entries take the
// pack's element count and chunk width and refuse a pack of another layout. One thread copies a
// chunk with one cp.async.bulk (no tensor map, so no libcuda) into a ring
// of two stages under mbarriers: chunk c + 1 streams in while chunk c
// computes. A chunk is 7-24 KB, a multiple of 512 bytes.
//
// Operand layouts: every wgmma operand is K-major bf16 with the 64-byte
// swizzle. C_IN = 96 is 192 bytes a row, not a multiple of the 128-byte
// atom, so K is split in planes of 32 channels (64-byte rows): a (rows, K)
// matrix is K/32 planes of (rows, 32), each 512-byte aligned, the 16-byte
// chunk q of row r stored at q ^ ((r >> 1) & 3). A K=16 step is plane
// k / 32 at byte offset 32 * (k / 16 % 2); 8-row groups are 512 bytes apart
// (SBO). The f32 expand tile uses an XOR of the pixel's low bits on the
// channel so that the accumulator stores and the depthwise loads are nearly
// free of bank conflicts. The flat tile has no XOR (its slots' low bits are
// not known at compile time): an odd pitch of 65 words a slot and channel c
// at word flat_word(c), so that a window load is a row base plus a constant
// and neither access conflicts. Generic-proxy stores that wgmma reads (input
// rows, depthwise output) are followed by fence.proxy.async before the
// barrier.
//
// Shared memory at R = 8, CH = 64: input rows 10 x 32 x K_IN bf16, the f32
// expand tile 320 x 64 (81,920 B), the dw output 256 x 64 bf16 (32,768 B),
// two weight stages; + 1,024 B alignment slack + barriers, of 232,448 B:
//   96 -> 96  61,440 + 81,920 + 32,768 + 2 x 24,576 = 225,280 B (largest)
//   64 -> 96  40,960 + 81,920 + 32,768 + 2 x 20,480 = 196,608 B
//   64 -> 64  40,960 + 81,920 + 32,768 + 2 x 16,384 = 188,416 B
//   32 -> 32  20,480 + 81,920 + 32,768 + 2 x  8,192 = 151,552 B
//   24 -> 24  20,480 + 81,920 + 32,768 + 2 x  7,168 = 149,504 B (K_IN 32)
// The flat tiling's tile is kSlots = 332 slots of 65 words (86,320 B), after
// the weight stages, and it adds the slot table (640 B), the h2 rows' pixels
// (512 B) and the units' window slots (128 B): 230,960 B at 96 -> 96.
// One block per SM in every case.
// Outputs are staged in shared memory (in the free expand tile, or a
// 32 KB tile in the tail) and written 16 bytes a thread along each pixel.
// The expand-only tail takes 256 consecutive pixels of an image a block
// (flat: it has no halo, so any S): the input (256 x K_IN bf16, 49,152 B at
// 96), two stages of 64 output channels (2 x 12,288 B at 96) and the
// 32,768 B output tile, 108 KB at most: two blocks per SM; its output is
// 151 MB at B = 128, S = 32.

#include "common.cuh"

namespace {

constexpr int R = 8;                 // output rows per thread block
constexpr int kCols = 32;            // pixel slots a row in shared memory
constexpr int kStrip = kCols - 2;    // output columns of a strip at S > 32
constexpr int P1 = (R + 2) * kCols;  // halo'd pixels: 5 M-tiles of 64
constexpr int P = R * kCols;         // output pixels: 4 M-tiles
constexpr int CH = 64;               // expand channels per chunk
constexpr int NC = 64;               // output channels per chunk of the tail
constexpr int kThreads = 256;        // two warpgroups
constexpr int kStages = 2;           // weight ring
constexpr int kAlign = 1024;         // slack to align the dynamic shared memory
// Slots of the flat tiling's expand tile: slot 0, the P1 staged pixels, a
// zero slot before each image row the run enters (at most 10 at S > 32), and
// the zero slot after its last row; kPitch f32 words a slot.
constexpr int kSlots = 332;
constexpr int kPitch = CH + 1;
static_assert(kSlots >= 1 + P1 + (kCols + P1 - 1) / (kCols + 1) + 1, "slots of a run at S > 32");
constexpr int kUnits = P / 8;        // flat: units of 8 outputs a block, 8 a thread

// Tilings of ir_block_kernel: one strip known at compile time (S <= 32),
// column strips, or flat runs of pixels.
enum Tiling { kOne, kStrips, kFlat };

__device__ __forceinline__ float relu6f(float v) { return fminf(fmaxf(v, 0.0f), 6.0f); }

// Word of channel c (< 64) in a slot of the flat expand tile: bits 1-2 and
// 3-4 of c swapped. With the odd pitch, an expand store (8 pixels x 4
// channel pairs, the pairs 2 apart) and a depthwise load (32 channels of a
// slot) each fall in 32 banks.
__host__ __device__ constexpr int flat_word(int c) {
  return (c & 0x21) | ((c >> 2) & 6) | ((c << 2) & 0x18);
}

// Channels as the kernel holds them: whole 32-channel planes of input,
// whole chunks of expanded channels.
__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(f32_to_bf16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(f32_to_bf16(hi)) << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, k) of a K-major bf16 matrix of `rows` rows
// in 64-byte-swizzled planes of 32 channels.
__device__ __forceinline__ int sw64(int rows, int row, int k) {
  return (k >> 5) * rows * 64 + row * 64 + ((((k >> 3) & 3) ^ ((row >> 1) & 3)) << 4) +
         ((k & 7) << 1);
}

// wgmma shared-memory descriptor of a K-major 64-byte-swizzled operand at
// shared address `addr`: LBO 1 (unused for swizzled K-major), SBO 512 bytes
// (one 8-row group), layout type 2 (64-byte swizzle).
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin accumulator registers in place around asynchronous wgmma work.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// d (64 x N f32, N = 2 x the accumulator count) += A (64 x 16) * B (16 x N),
// both bf16 from shared memory through descriptors a and b; the fragment of
// thread t of the warpgroup: d[4j + 2h + e] is row 16 (t / 32) + (t % 32) / 4
// + 8h, column 8j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_bf16(float (&d)[12], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// Load image rows [first_row, first_row + rows) of x (S x S x C_IN bf16,
// NHWC), slot j of a row holding image column cbase + j, into xs (rows * 32
// pixels, swizzled planes of K_IN channels), 16 bytes at a time; pixels
// outside the image and channels from C_IN to K_IN are zero. Fenced for
// wgmma; the caller syncs.
template <int C_IN, int K_IN>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ xb, unsigned char* xs,
                                          int first_row, int rows, int S, int cbase) {
  constexpr int Q = K_IN / 8;  // 16-byte pieces a pixel
  const int np = rows * kCols;
  for (int i = threadIdx.x; i < np * Q; i += kThreads) {
    const int p = i / Q, q = i % Q;
    const int row = first_row + p / kCols, col = cbase + p % kCols;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (8 * q < C_IN && row >= 0 && row < S && col >= 0 && col < S)
      v = *reinterpret_cast<const uint4*>(xb + ((size_t)row * S + col) * C_IN + 8 * q);
    *reinterpret_cast<uint4*>(xs + sw64(np, p, 8 * q)) = v;
  }
  fence_proxy_async();
}

// Load pixels [f0, f0 + P) of an image of n pixels (C_IN bf16 each) into xs
// (P pixels, swizzled planes of K_IN channels); pixels past n and channels
// from C_IN to K_IN are zero. Fenced for wgmma; the caller syncs.
template <int C_IN, int K_IN>
__device__ __forceinline__ void load_flat(const __nv_bfloat16* __restrict__ xb, unsigned char* xs,
                                          int f0, int n) {
  constexpr int Q = K_IN / 8;
  for (int i = threadIdx.x; i < P * Q; i += kThreads) {
    const int p = i / Q, q = i % Q;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (8 * q < C_IN && f0 + p < n)
      v = *reinterpret_cast<const uint4*>(xb + (size_t)(f0 + p) * C_IN + 8 * q);
    *reinterpret_cast<uint4*>(xs + sw64(P, p, 8 * q)) = v;
  }
  fence_proxy_async();
}

// Load the pixels [g0, g0 + P1) of an image of n pixels (C_IN bf16 each)
// into xs (P1 pixels, swizzled planes of K_IN channels); pixels outside
// [0, n) and channels from C_IN to K_IN are zero. Fenced for wgmma; the
// caller syncs.
template <int C_IN, int K_IN>
__device__ __forceinline__ void load_halo(const __nv_bfloat16* __restrict__ xb, unsigned char* xs,
                                          int g0, int n) {
  constexpr int Q = K_IN / 8;
  for (int i = threadIdx.x; i < P1 * Q; i += kThreads) {
    const int p = i / Q, q = i % Q, g = g0 + p;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (8 * q < C_IN && g >= 0 && g < n)
      v = *reinterpret_cast<const uint4*>(xb + (size_t)g * C_IN + 8 * q);
    *reinterpret_cast<uint4*>(xs + sw64(P1, p, 8 * q)) = v;
  }
  fence_proxy_async();
}

// Start (and commit) warpgroup wg's expand of M-tile mt: channels
// [32wg, 32wg + 32) of the chunk in stage we_s at halo'd pixels
// [64mt, 64mt + 64), into zeroed accumulators.
template <int K_IN>
__device__ __forceinline__ void expand_tile(float (&acc)[16], const unsigned char* xs,
                                            const unsigned char* we_s, int mt, int wg) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < K_IN / 16; ++ks) {
    const int koff = (ks & 1) * 32;
    wgmma_bf16(acc, desc_sw64(smem_u32(xs + (ks >> 1) * P1 * 64 + mt * 64 * 64 + koff)),
               desc_sw64(smem_u32(we_s + (ks >> 1) * CH * 64 + 32 * wg * 64 + koff)));
  }
  wgmma_commit();
}

// The output tile of a thread block, staged in shared memory for coalesced
// 16-byte stores: RSW 32-bit words a pixel, word w of pixel p at
// w ^ ((p & 7) << 2) (accumulator-fragment stores free of bank conflicts).
template <int RSW>
__device__ __forceinline__ void stage_word(uint32_t* ot, int p, int w, uint32_t v) {
  ot[p * RSW + (w ^ ((p & 7) << 2))] = v;
}

// The staged piece k (8 channels) of pixel p, as a 16-byte word.
template <int RSW>
__device__ __forceinline__ uint4 staged_piece(const uint32_t* ot, int p, int k) {
  return reinterpret_cast<const uint4*>(ot)[p * (RSW / 4) + (k ^ (p & 7))];
}

// Copy a block's staged tile out, 16 bytes a thread, consecutive threads
// along a pixel: slot p (tile row r0 + p / 32, image column cbase + p % 32)
// goes to bf16 channels [0, 8 * PIECES) of its pixel of `ld` channels in
// img, for the slots [olo, ohi) of each row inside the image.
template <int RSW, int PIECES>
__device__ __forceinline__ void store_tile(const uint32_t* ot, __nv_bfloat16* img, int ld, int r0,
                                           int cbase, int olo, int ohi, int S) {
  for (int i = threadIdx.x; i < P * PIECES; i += kThreads) {
    const int p = i / PIECES, k = i % PIECES;
    const int row = r0 + p / kCols, slot = p % kCols;
    if (row < S && slot >= olo && slot < ohi)
      *reinterpret_cast<uint4*>(img + ((size_t)row * S + cbase + slot) * ld + 8 * k) =
          staged_piece<RSW>(ot, p, k);
  }
}

// Copy a flat block's staged tile out: tile row p to pixel f0 + pix[p] of
// img, where pix[p] >= 0.
template <int RSW, int PIECES>
__device__ __forceinline__ void store_flat(const uint32_t* ot, __nv_bfloat16* img, int ld, int f0,
                                           const int16_t* pix) {
  for (int i = threadIdx.x; i < P * PIECES; i += kThreads) {
    const int p = i / PIECES, k = i % PIECES, j = pix[p];
    if (j >= 0)
      *reinterpret_cast<uint4*>(img + (size_t)(f0 + j) * ld + 8 * k) = staged_piece<RSW>(ot, p, k);
  }
}

template <int C_IN, int C_OUT, bool FLAT>
constexpr size_t block_smem_bytes() {
  constexpr int K_IN = round_up(C_IN, 32);
  return (size_t)P1 * K_IN * 2 + (size_t)(FLAT ? kSlots * kPitch : P1 * CH) * 4 +
         (size_t)P * CH * 2 +
         (size_t)kStages * (CH * K_IN + C_OUT * CH) * 2 + kStages * 8 +
         (FLAT ? P1 * 2 + P * 2 + kUnits * 4 : 0) + kAlign;
}

// One row of a flat block's depthwise window: the 10 slots from sb of the
// expand tile (hd: the tile at this thread's channel word).
__device__ __forceinline__ void flat_window_row(float (&w)[10], const float* hd, int sb) {
#pragma unroll
  for (int i = 0; i < 10; ++i) w[i] = hd[(sb + i) * kPitch];
}

// The depthwise of one unit of a flat block: outputs i < 8 from the window
// rows a (above), b, c (below), in tpurpn's tap order, + bias, ReLU6, bf16
// into h2 rows 8u + i (h2u: row 8u at channel dc; q: dc's 16-byte piece).
template <bool DW_BF16>
__device__ __forceinline__ void flat_out_row(const float (&a)[10], const float (&b)[10],
                                             const float (&c)[10], const float (&tap)[9],
                                             float bias, unsigned char* h2u, int q) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float hv = (dy == 0 ? a : dy == 1 ? b : c)[i + dx];
        if constexpr (DW_BF16)
          acc = __fadd_rn(acc, round_bf16(__fmul_rn(hv, tap[dy * 3 + dx])));
        else
          acc = __fmaf_rn(hv, tap[dy * 3 + dx], acc);
      }
    *reinterpret_cast<__nv_bfloat16*>(h2u + i * 64 + ((q ^ ((i >> 1) & 3)) << 4)) =
        f32_to_bf16(relu6f(acc + bias));
  }
}

// The strip of thread block x of a block row: the image column of slot 0
// and the output slots [olo, ohi). One strip at S <= 32 (slot j = column
// j); otherwise nstrips strips of sw <= kStrip columns, outputs at slots
// 1..sw and the halo columns beside them.
struct Strip {
  int cbase, olo, ohi;
};
__device__ __forceinline__ Strip strip_of(int s, int nstrips, int sw, int S) {
  if (nstrips == 1) return {0, 0, S};
  return {s * sw - 1, 1, 1 + min(sw, S - s * sw)};
}

// A parameter of expanded channel ch (of C_EXP_REAL real ones, held as
// C_EXP): 0 on the pad channels.
template <int C_EXP_REAL, int C_EXP>
__device__ __forceinline__ float exp_param(const float* __restrict__ v, int ch) {
  if constexpr (C_EXP_REAL == C_EXP) return v[ch];
  else return ch < C_EXP_REAL ? v[ch] : 0.0f;
}

// One full block over one tile. DW_BF16: tpurpn's dw_input_bf16. TILING:
// kOne, one strip of R rows at S <= 32 with its bounds known at compile
// time (the serving stage's instance at 500 px); kStrips, a column strip of
// R rows (`strips` strips of `width` columns a row); kFlat, the `width`
// pixels from blockIdx.x * width in row-major order.
template <int C_IN, int C_OUT, bool RESIDUAL, bool DW_BF16, int TILING>
__global__ void __launch_bounds__(kThreads, 1) ir_block_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    const unsigned char* __restrict__ pack, const float* __restrict__ be,
    const float* __restrict__ kdw, const float* __restrict__ bdw, const float* __restrict__ bp,
    int S, int strips, int width) {
  constexpr bool STRIPS = TILING == kStrips, FLAT = TILING == kFlat;
  constexpr int K_IN = round_up(C_IN, 32);                // input channels held
  constexpr int C_EXP_REAL = 6 * C_IN;
  constexpr int C_EXP = round_up(C_EXP_REAL, CH);         // expanded channels held
  constexpr int NCHUNK = C_EXP / CH;
  constexpr int WE_BYTES = CH * K_IN * 2;                 // expand weights of a chunk
  constexpr int CHUNK_BYTES = WE_BYTES + C_OUT * CH * 2;  // + project weights
  constexpr int NH = C_OUT / 2;                           // accumulators of one M-tile
  constexpr int HS_BYTES = (FLAT ? kSlots * kPitch : P1 * CH) * 4;  // the expand tile
  static_assert(NCHUNK >= kStages, "the ring is filled before the loop");
  static_assert(CHUNK_BYTES % 512 == 0, "stages stay 512-byte aligned");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [xs][hs][h2][stages][barriers], flat [xs][h2][stages][hs][barriers][tables]
  unsigned char* xs = align_smem(smem_raw);                        // [P1][K_IN] planes
  // the f32 expand tile: (pixel p, channel c) at p * CH + (c ^ ((p & 7) << 2));
  // flat, (slot s, c) at s * kPitch + flat_word(c)
  unsigned char* h2 = xs + P1 * K_IN * 2 + (FLAT ? 0 : HS_BYTES);   // [P][CH] planes
  unsigned char* stage = h2 + P * CH * 2;                          // kStages x chunk
  float* hs = reinterpret_cast<float*>(FLAT ? stage + kStages * CHUNK_BYTES : xs + P1 * K_IN * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      FLAT ? reinterpret_cast<unsigned char*>(hs) + HS_BYTES : stage + kStages * CHUNK_BYTES);
  // flat: the slot of each staged pixel; the output pixel (- f0) of each h2
  // row, -1 for none; the window slot of each unit
  uint16_t* slot_of = reinterpret_cast<uint16_t*>(full + kStages);
  int16_t* pix_of = reinterpret_cast<int16_t*>(slot_of + P1);
  int* unit_sb = reinterpret_cast<int*>(pix_of + P);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wg = t >> 7, wi = warp & 3;  // warpgroup, warp within it
  const int b = blockIdx.y;
  const int r0 = FLAT ? 0 : (STRIPS ? blockIdx.x / strips : blockIdx.x) * R;
  const Strip st = STRIPS ? strip_of(blockIdx.x % strips, strips, width, S) : Strip{0, 0, S};
  const int g0 = FLAT ? blockIdx.x * width - S - 1 : 0;  // flat: pixel of tile row 0

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages; ++s)
      bulk_load(stage + s * CHUNK_BYTES, pack + (size_t)s * CHUNK_BYTES, CHUNK_BYTES, &full[s]);
  }
  if constexpr (FLAT) {
    load_halo<C_IN, K_IN>(x + (size_t)b * S * S * C_IN, xs, g0, S * S);
    // the zero slots stay zero: the expand writes only the staged pixels'
    for (int i = t; i < HS_BYTES / 16; i += kThreads)
      reinterpret_cast<float4*>(hs)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // tile row p = pixel g0 + p = (y0 + w, x) goes to slot p + 1 + w
    const int y0 = (g0 + 2 * S) / S - 2, x0 = g0 - y0 * S;
    for (int p = t; p < P1; p += kThreads) slot_of[p] = (uint16_t)(p + 1 + (x0 + p) / S);
    // The block's outputs [f0, f0 + nv) span image rows ya..yb (at least
    // 3), row y from column lo (ca in row ya, else 0) to hi (cb in row yb,
    // else S - 1), as units of 8 columns: the first row's from ca on; then,
    // for each k, columns [8k, 8k + 8) of rows ya + 1 .. yb, down the rows.
    // A unit that would pass hi starts at hi - 7 instead (in row ya not
    // before ca), so every window lies in the staged run, and leaves the
    // columns before its own to the unit before. Thread u < kUnits places
    // unit u: its window from column start - 1 of row y - 1, its outputs in
    // h2 rows 8u .. 8u + 7; a slot past the last unit reads from slot 0 into
    // rows no pixel takes.
    if (t < kUnits) {
      const int f0 = g0 + S + 1, nv = min(width, S * S - f0);
      const int ya = f0 / S, ca = f0 - ya * S, yb = (f0 + nv - 1) / S;
      const int cb = f0 + nv - 1 - yb * S, nseg = (S + 7) >> 3;
      const int first = (S - ca + 7) >> 3, last = (cb + 8) >> 3;  // units of rows ya, yb
      int y = -1, k = 0, u = t;
      if (u < first) {
        y = ya, k = u;
      } else {
        u -= first;
        for (int kk = 0; kk < nseg && y < 0; ++kk) {
          const int rows = yb - ya - 1 + (kk < last);
          if (u < rows) y = ya + 1 + u, k = kk;
          else u -= rows;
        }
      }
      const int hi = y == yb ? cb : S - 1, ns = (y == ya ? ca : 0) + 8 * k;  // nominal start
      const int st = y == ya ? max(ca, min(ns, hi - 7)) : min(ns, hi - 7);
      unit_sb[t] = y >= 0 ? (y - 1 - y0) * (S + 1) + st - x0 : 0;
      for (int i = 0; i < 8; ++i) {
        const int xc = st + i;
        const bool mine = y >= 0 && xc >= ns && xc < ns + 8 && xc <= hi;
        pix_of[8 * t + i] = (int16_t)(mine ? y * S + xc - f0 : -1);
      }
    }
  } else {
    load_rows<C_IN, K_IN>(x + (size_t)b * S * S * C_IN, xs, r0 - 1, R + 2, S, st.cbase);
  }
  __syncthreads();

  float y0[NH], y1[NH];  // projection of M-tiles 2wg and 2wg + 1
#pragma unroll
  for (int i = 0; i < NH; ++i) y0[i] = y1[i] = 0.0f;

  // the depthwise thread's channel and strip of slots
  const int dc = 32 * (warp & 1) + lane, col0 = 8 * (warp >> 1);

  for (int c = 0; c < NCHUNK; ++c) {
    const int s = c % kStages;
    const int c0 = c * CH;
    unsigned char* we_s = stage + s * CHUNK_BYTES;
    unsigned char* wp_s = we_s + WE_BYTES;
    mbar_wait(&full[s], (c / kStages) & 1);

    // 1. expand: channels [32wg, 32wg + 32) of the chunk at every halo'd pixel.
    //    Thread (wi, lane) holds pixels 64mt + 16wi + g + 8h (g = lane / 4):
    //    tile row r0 - 1 + 2mt + wi / 2, slot 16 (wi % 2) + g + 8h, and
    //    channels 32wg + 8j + 2 (lane % 4) + e, stored at channel ^ 4g (flat:
    //    in its slot, at the channel's word).
    float bias[8];
    int chs[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int ch = 32 * wg + 8 * (v >> 1) + 2 * (lane & 3) + (v & 1);
      bias[v] = exp_param<C_EXP_REAL, C_EXP>(be, c0 + ch);
      chs[v] = ch ^ ((lane >> 2) << 2);
    }
    // Tile mt + 1 is started before tile mt is stored (two accumulator sets),
    // and the first wait also retires the previous chunk's projection.
    float acc[2][16];
    expand_tile<K_IN>(acc[0], xs, we_s, 0, wg);
#pragma unroll
    for (int mt = 0; mt < P1 / 64; ++mt) {
      if (mt + 1 < P1 / 64) {
        expand_tile<K_IN>(acc[(mt + 1) & 1], xs, we_s, mt + 1, wg);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(acc[mt & 1]);
      const int row = r0 - 1 + 2 * mt + (wi >> 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // SAME zero padding of h; channel ch of the pixel goes to hp[chs],
        // flat hp[flat_word(ch)] (linear over the bit fields of ch)
        bool inside;
        float* hp;
        if constexpr (FLAT) {
          const int p = 64 * mt + 16 * wi + (lane >> 2) + 8 * h;
          inside = g0 + p >= 0 && g0 + p < S * S;
          hp = hs + slot_of[p] * kPitch + flat_word(32 * wg + 2 * (lane & 3));
        } else {
          const int col = st.cbase + 16 * (wi & 1) + (lane >> 2) + 8 * h;
          inside = row >= 0 && row < S && (!STRIPS || col >= 0) && col < S;
          hp = hs + (64 * mt + 16 * wi + (lane >> 2) + 8 * h) * CH;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& dst = hp[FLAT ? flat_word(8 * j + e) : chs[2 * j + e]];
            if constexpr (DW_BF16)
              dst = inside ? round_bf16(relu6f(acc[mt & 1][4 * j + 2 * h + e] + bias[2 * j + e]))
                           : 0.0f;
            else
              dst = inside ? relu6f(acc[mt & 1][4 * j + 2 * h + e] + bias[2 * j + e]) : 0.0f;
          }
      }
    }
    __syncthreads();  // hs holds the chunk; every warpgroup is done with chunk c - 1

    // stage (c + 1) % kStages held chunk c - 1, whose projection is finished
    if (t == 0 && c + 1 >= kStages && c + 1 < NCHUNK)
      bulk_load(stage + ((c + 1) % kStages) * CHUNK_BYTES, pack + (size_t)(c + 1) * CHUNK_BYTES,
                CHUNK_BYTES, &full[(c + 1) % kStages]);

    // 2. 3x3 depthwise (stride 1, SAME) + bias + ReLU6 -> bf16 into h2.
    {
      float tap[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float v = exp_param<C_EXP_REAL, C_EXP>(kdw + k * C_EXP_REAL, c0 + dc);
        tap[k] = DW_BF16 ? round_bf16(v) : v;
      }
      const float bias = exp_param<C_EXP_REAL, C_EXP>(bdw, c0 + dc);
      if constexpr (FLAT) {
        // Units 8qt .. 8qt + 7 (qt = warp / 2) as two streams walked side by
        // side, units r and r + 4 at step r (two independent chains of loads
        // and products). A unit below the one before it in its stream (window
        // slot + pitch) keeps two window rows.
        const int qt = warp >> 1, pitch = S + 1, q = (dc >> 3) & 3;
        const float* hd = hs + flat_word(dc);
        unsigned char* h2t = h2 + (dc >> 5) * P * 64 + qt * 64 * 64 + ((dc & 7) << 1);
        int sb[8];
        bool keep[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) sb[r] = unit_sb[8 * qt + r];
#pragma unroll
        for (int r = 0; r < 8; ++r) keep[r] = (r & 3) != 0 && sb[r] == sb[(r + 7) & 7] + pitch;
        float wa[3][10], wb[3][10];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (!keep[r]) {
            flat_window_row(wa[r % 3], hd, sb[r]);
            flat_window_row(wa[(r + 1) % 3], hd, sb[r] + pitch);
          }
          if (!keep[r + 4]) {
            flat_window_row(wb[r % 3], hd, sb[r + 4]);
            flat_window_row(wb[(r + 1) % 3], hd, sb[r + 4] + pitch);
          }
          flat_window_row(wa[(r + 2) % 3], hd, sb[r] + 2 * pitch);
          flat_window_row(wb[(r + 2) % 3], hd, sb[r + 4] + 2 * pitch);
          flat_out_row<DW_BF16>(wa[r % 3], wa[(r + 1) % 3], wa[(r + 2) % 3], tap, bias,
                                h2t + r * 8 * 64, q);
          flat_out_row<DW_BF16>(wb[r % 3], wb[(r + 1) % 3], wb[(r + 2) % 3], tap, bias,
                                h2t + (r + 4) * 8 * 64, q);
        }
      } else {
        // A thread owns a strip of 8 slots and walks down the R rows. The
        // strip's slots col0 - 1 + i have i - 1 as their low 3 bits, so every
        // swizzle below is known at compile time but for dc. Slots -1 and 32
        // are never an output's neighbour inside the image: zero.
        const int hs0 = col0 * CH;  // slot col0 of row 0 in the expand tile
        unsigned char* h2t = h2 + (dc >> 5) * P * 64 + col0 * 64 + ((dc & 7) << 1);
        const int q = (dc >> 3) & 3;  // dc's 16-byte piece in its plane row
        float win[3][10];
#pragma unroll
        for (int r = 0; r < R + 2; ++r) {
          float(&w)[10] = win[r % 3];
#pragma unroll
          for (int i = 0; i < 10; ++i) {
            const bool in = (i > 0 || col0 > 0) && (i < 9 || col0 < kCols - 8);  // slots 0..31
            w[i] = in ? hs[hs0 + (r * kCols + i - 1) * CH + (dc ^ (((i + 7) & 7) << 2))] : 0.0f;
          }
          if (r < 2) continue;
          const int orow = r - 2;  // output row of the tile
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float acc = 0.0f;
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const float hv = win[(orow + dy) % 3][i + dx];
                if constexpr (DW_BF16)  // bf16 product, f32 sum, in tpurpn's tap order
                  acc = __fadd_rn(acc, round_bf16(__fmul_rn(hv, tap[dy * 3 + dx])));
                else
                  acc = __fmaf_rn(hv, tap[dy * 3 + dx], acc);
              }
            // = h2 + sw64(P, orow * kCols + col0 + i, dc)
            *reinterpret_cast<__nv_bfloat16*>(h2t + (orow * kCols + i) * 64 +
                                              ((q ^ ((i >> 1) & 3)) << 4)) =
                f32_to_bf16(relu6f(acc + bias));
          }
        }
      }
    }
    fence_proxy_async();
    __syncthreads();  // h2 holds the chunk's depthwise output

    // 3. this chunk's share of the projection, M-tiles 2wg and 2wg + 1
    fence_regs(y0);
    fence_regs(y1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CH / 16; ++ks) {
      const int koff = (ks & 1) * 32;
      const uint64_t db = desc_sw64(smem_u32(wp_s + (ks >> 1) * C_OUT * 64 + koff));
      const unsigned char* a = h2 + (ks >> 1) * P * 64 + (2 * wg) * 64 * 64 + koff;
      wgmma_bf16(y0, desc_sw64(smem_u32(a)), db);
      wgmma_bf16(y1, desc_sw64(smem_u32(a + 64 * 64)), db);
    }
    wgmma_commit();  // retired by the next chunk's first wait, or below
  }
  wgmma_wait<0>();
  fence_regs(y0);
  fence_regs(y1);

  // epilogue: + bias -> bf16 (-> + residual in bf16), staged in hs (free
  // since the last depthwise) as channel pairs, then stored coalesced. The
  // input of output p is staged in row p + kCols; flat, of pixel f0 + j in
  // row j + S + 1 (rows of no pixel read row S + 1).
  uint32_t* ot = reinterpret_cast<uint32_t*>(hs);  // [P][64] words
  static_assert(P * 64 * 4 <= HS_BYTES && C_OUT <= 128, "the output tile fits in hs");
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float(&y)[NH] = m ? y1 : y0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 64 * (2 * wg + m) + 16 * wi + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < NH / 4; ++j) {
        const int ch = 8 * j + 2 * (lane & 3);
        float v0 = round_bf16(y[4 * j + 2 * h] + bp[ch]);
        float v1 = round_bf16(y[4 * j + 2 * h + 1] + bp[ch + 1]);
        if (RESIDUAL) {
          const int px = FLAT ? max((int)pix_of[p], 0) + S + 1 : p + kCols;
          const uint32_t v = *reinterpret_cast<const uint32_t*>(xs + sw64(P1, px, ch));
          v0 = bf16_lo(v) + v0;
          v1 = bf16_hi(v) + v1;
        }
        stage_word<64>(ot, p, ch / 2, pack_bf16(v0, v1));
      }
    }
  }
  __syncthreads();
  if constexpr (FLAT)
    store_flat<64, C_OUT / 8>(ot, out + (size_t)b * S * S * C_OUT, C_OUT, g0 + S + 1, pix_of);
  else
    store_tile<64, C_OUT / 8>(ot, out + (size_t)b * S * S * C_OUT, C_OUT, r0, st.cbase, st.olo,
                              st.ohi, S);
}

// The expand-only tail: out = bf16(ReLU6(x @ we + be)), P consecutive
// pixels of one image a block (no halo: the image as one flat run), NC
// output channels a chunk; warpgroup g owns M-tiles 2g and 2g + 1. FULL:
// c_exp is whole chunks; without, the last chunk is partial (c_exp = 144)
// and its missing channels are neither read nor written.
template <int C_IN, bool FULL>
__global__ void __launch_bounds__(kThreads, 2) ir_expand_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    const unsigned char* __restrict__ pack, const float* __restrict__ be, int S, int C_EXP) {
  constexpr int K_IN = round_up(C_IN, 32);
  constexpr int CHUNK_BYTES = NC * K_IN * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* xs = align_smem(smem_raw);  // [P][K_IN] planes
  unsigned char* stage = xs + P * K_IN * 2;
  uint32_t* ot = reinterpret_cast<uint32_t*>(stage + kStages * CHUNK_BYTES);  // [P][NC / 2]
  uint64_t* full = reinterpret_cast<uint64_t*>(ot + P * NC / 2);

  const int t = threadIdx.x, lane = t & 31;
  const int wg = t >> 7, wi = (t >> 5) & 3;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * P, npix = S * S;
  const int nchunk = (C_EXP + NC - 1) / NC;

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < nchunk; ++s)
      bulk_load(stage + s * CHUNK_BYTES, pack + (size_t)s * CHUNK_BYTES, CHUNK_BYTES, &full[s]);
  }
  load_flat<C_IN, K_IN>(x + (size_t)b * npix * C_IN, xs, f0, npix);
  __syncthreads();

  for (int c = 0; c < nchunk; ++c) {
    const int s = c % kStages;
    unsigned char* we_s = stage + s * CHUNK_BYTES;
    mbar_wait(&full[s], (c / kStages) & 1);
    float acc0[NC / 2], acc1[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc0[i] = acc1[i] = 0.0f;
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < K_IN / 16; ++ks) {
      const int koff = (ks & 1) * 32;
      const uint64_t db = desc_sw64(smem_u32(we_s + (ks >> 1) * NC * 64 + koff));
      const unsigned char* a = xs + (ks >> 1) * P * 64 + (2 * wg) * 64 * 64 + koff;
      wgmma_bf16(acc0, desc_sw64(smem_u32(a)), db);
      wgmma_bf16(acc1, desc_sw64(smem_u32(a + 64 * 64)), db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    __syncthreads();  // every warpgroup has read stage s; the last tile is out
    if (t == 0 && c + kStages < nchunk)
      bulk_load(we_s, pack + (size_t)(c + kStages) * CHUNK_BYTES, CHUNK_BYTES, &full[s]);

#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float(&a)[NC / 2] = m ? acc1 : acc0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 64 * (2 * wg + m) + 16 * wi + (lane >> 2) + 8 * h;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int ch = c * NC + 8 * j + 2 * (lane & 3);
          const float b0 = FULL || ch < C_EXP ? be[ch] : 0.0f;
          const float b1 = FULL || ch + 1 < C_EXP ? be[ch + 1] : 0.0f;
          stage_word<NC / 2>(ot, p, (ch - c * NC) / 2,
                             pack_bf16(relu6f(a[4 * j + 2 * h] + b0),
                                       relu6f(a[4 * j + 2 * h + 1] + b1)));
        }
      }
    }
    __syncthreads();
    // the chunk's channels that exist, 16 bytes a thread along each pixel
    const int pieces = min(NC, C_EXP - c * NC) / 8;
    __nv_bfloat16* img = out + (size_t)b * npix * C_EXP + c * NC;
    for (int i = threadIdx.x; i < P * (NC / 8); i += kThreads) {
      const int p = i / (NC / 8), k = i % (NC / 8);
      if ((FULL || k < pieces) && f0 + p < npix)
        *reinterpret_cast<uint4*>(img + (size_t)(f0 + p) * C_EXP + 8 * k) =
            staged_piece<NC / 2>(ot, p, k);
    }
  }
}

template <int C_IN, int C_OUT, bool RESIDUAL, bool DW_BF16, int TILING>
cudaError_t launch_block(const __nv_bfloat16* x, __nv_bfloat16* out, const unsigned char* pack,
                         const float* be, const float* kdw, const float* bdw, const float* bp,
                         int B, int S, int strips, int width, cudaStream_t stream) {
  auto kernel = ir_block_kernel<C_IN, C_OUT, RESIDUAL, DW_BF16, TILING>;
  const size_t smem = block_smem_bytes<C_IN, C_OUT, TILING == kFlat>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = TILING == kFlat ? (S * S + width - 1) / width : (S + R - 1) / R * strips;
  const dim3 grid(blocks, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, pack, be, kdw, bdw, bp, S, strips, width);
  return cudaGetLastError();
}

// The five instances of one spec: flat or strips, dw_input_bf16 or not, and
// the plain one strip at S <= 32 without.
template <int C_IN, int C_OUT, bool RESIDUAL>
cudaError_t launch_spec(const __nv_bfloat16* x, __nv_bfloat16* out, const unsigned char* pack,
                        const float* be, const float* kdw, const float* bdw, const float* bp,
                        int B, int S, int strips, int width, bool dw_bf16, cudaStream_t stream) {
  if (strips == 0 && dw_bf16)
    return launch_block<C_IN, C_OUT, RESIDUAL, true, kFlat>(x, out, pack, be, kdw, bdw, bp, B, S,
                                                            strips, width, stream);
  if (strips == 0)
    return launch_block<C_IN, C_OUT, RESIDUAL, false, kFlat>(x, out, pack, be, kdw, bdw, bp, B, S,
                                                             strips, width, stream);
  if (dw_bf16)
    return launch_block<C_IN, C_OUT, RESIDUAL, true, kStrips>(x, out, pack, be, kdw, bdw, bp, B,
                                                              S, strips, width, stream);
  if (strips == 1)
    return launch_block<C_IN, C_OUT, RESIDUAL, false, kOne>(x, out, pack, be, kdw, bdw, bp, B, S,
                                                            strips, width, stream);
  return launch_block<C_IN, C_OUT, RESIDUAL, false, kStrips>(x, out, pack, be, kdw, bdw, bp, B, S,
                                                             strips, width, stream);
}

// A tiling the kernel takes (kernels/ir_stage.py: ir_block_plan chooses
// one): strips == 0, flat runs of `width` pixels at S > 32 whose halo'd run
// fits the tile, each over 3 image rows or more and of at most kUnits
// units; one strip of width S at S <= 32;
// or `strips` strips of `width` <= kStrip columns, none empty, covering the
// row.
bool valid_tiling(int S, int strips, int width) {
  if (strips == 0) {
    if (S <= kCols || width < 1 || width + 2 * (S + 1) > P1) return false;
    for (int f0 = 0; f0 < S * S; f0 += width) {  // 3 rows or more, at most kUnits units
      const int last = min(f0 + width, S * S) - 1, rows = last / S - f0 / S + 1;
      const int units = (S - f0 % S + 7) / 8 + (rows - 2) * ((S + 7) / 8) + (last % S + 8) / 8;
      if (rows < 3 || units > kUnits) return false;
    }
    return true;
  }
  if (strips == 1) return S <= kCols && width == S;
  return strips > 1 && width >= 1 && width <= kStrip && (strips - 1) * width < S &&
         S <= strips * width;
}

template <int C_IN>
cudaError_t launch_expand(const void* x, void* out, const void* pack, const float* be, int B,
                          int S, int c_exp, cudaStream_t stream) {
  constexpr int K_IN = round_up(C_IN, 32);
  auto kernel = c_exp % NC ? ir_expand_kernel<C_IN, false> : ir_expand_kernel<C_IN, true>;
  const size_t smem = (size_t)P * K_IN * 2 + kStages * (size_t)NC * K_IN * 2 +
                      (size_t)P * NC * 2 + kStages * 8 + kAlign;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S * S + P - 1) / P, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
      static_cast<const unsigned char*>(pack), be, S, c_exp);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One full inverted-residual block at stride 1: (B, S, S, c_in) bf16 ->
// (B, S, S, c_out) bf16, any S >= 1. `pack` holds the block's per-chunk
// weight images (kernels/ir_stage.py: kernel_pack), `pack_elems` bf16 in
// chunks of `chunk` expanded channels, padded to the held widths. Specs:
// (c_in, c_exp, c_out, residual) = (24, 144, 24, 1), (32, 192, 32, 1),
// (64, 384, 64, 1), (64, 384, 96, 0), (96, 576, 96, 1); others are refused.
// dw_bf16: tpurpn's dw_input_bf16. The tiling is (strips, width) of
// kernels/ir_stage.py's ir_block_plan(S): flat runs of `width` pixels
// (strips = 0) where they take fewer thread blocks an image than column
// strips (S = 40, 47 and 63 among them), else `strips` strips of `width`
// columns (one strip at S <= 32); valid_tiling refuses any other.
TPURPN_EXPORT int ir_block(const void* x, void* out, const void* pack, int pack_elems, int chunk,
                           const float* be, const float* kdw, const float* bdw, const float* bp,
                           int B, int S, int strips, int width, int c_in, int c_exp, int c_out,
                           int residual, int dw_bf16, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || !valid_tiling(S, strips, width) || chunk != CH || c_exp != 6 * c_in ||
      pack_elems != round_up(c_exp, CH) * (round_up(c_in, 32) + c_out) || !aligned16(x) ||
      !aligned16(out) || !aligned16(pack))
    return cudaErrorInvalidValue;
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto ob = static_cast<__nv_bfloat16*>(out);
  auto pk = static_cast<const unsigned char*>(pack);
  const bool dw = dw_bf16 != 0;
  if (c_in == 24 && c_out == 24 && residual)
    return launch_spec<24, 24, true>(xb, ob, pk, be, kdw, bdw, bp, B, S, strips, width, dw,
                                    stream);
  if (c_in == 32 && c_out == 32 && residual)
    return launch_spec<32, 32, true>(xb, ob, pk, be, kdw, bdw, bp, B, S, strips, width, dw,
                                    stream);
  if (c_in == 64 && c_out == 64 && residual)
    return launch_spec<64, 64, true>(xb, ob, pk, be, kdw, bdw, bp, B, S, strips, width, dw,
                                    stream);
  if (c_in == 64 && c_out == 96 && !residual)
    return launch_spec<64, 96, false>(xb, ob, pk, be, kdw, bdw, bp, B, S, strips, width, dw,
                                     stream);
  if (c_in == 96 && c_out == 96 && residual)
    return launch_spec<96, 96, true>(xb, ob, pk, be, kdw, bdw, bp, B, S, strips, width, dw,
                                    stream);
  return cudaErrorInvalidValue;
}

// The expand-only tail: (B, S, S, c_in) bf16 -> (B, S, S, c_exp) bf16, any
// S >= 1, c_in in {24, 32, 64, 96} and c_exp = 6 c_in; `pack` is
// `pack_elems` bf16 in chunks of `chunk` output channels, padded to the
// held widths.
TPURPN_EXPORT int ir_expand(const void* x, void* out, const void* pack, int pack_elems,
                            int chunk, const float* be, int B, int S, int c_in, int c_exp,
                            cudaStream_t stream) {
  if (B <= 0 || S <= 0 || c_exp != 6 * c_in || chunk != NC ||
      pack_elems != round_up(c_in, 32) * round_up(c_exp, NC) || !aligned16(x) ||
      !aligned16(out) || !aligned16(pack))
    return cudaErrorInvalidValue;
  switch (c_in) {
    case 24: return launch_expand<24>(x, out, pack, be, B, S, c_exp, stream);
    case 32: return launch_expand<32>(x, out, pack, be, B, S, c_exp, stream);
    case 64: return launch_expand<64>(x, out, pack, be, B, S, c_exp, stream);
    case 96: return launch_expand<96>(x, out, pack, be, B, S, c_exp, stream);
    default: return cudaErrorInvalidValue;
  }
}

TPURPN_EXPORT const char* ir_stage_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
