// Shared helpers of the port's CUDA kernels (plain C interface, loaded with
// ctypes by tpurpn_torch/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TPURPN_EXPORT extern "C" __attribute__((visibility("default")))

// bf16 <-> f32 on raw bit patterns: no rounding mode question on the way up,
// round-to-nearest-even on the way down (what torch's .to(bfloat16) does).
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }
__device__ __forceinline__ float bf16_to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 f32_to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Box geometry op for op as tpurpn.boxes (bbox_area, generate_iou_map) on
// [y1, x1, y2, x2] boxes. The files that use it are built with -fmad=false
// and without fast math: no product is contracted into an FMA and the
// division is IEEE, so every IoU rounds as the plain versions' do. The IoU
// is symmetric bit for bit (every operation used commutes).
__device__ __forceinline__ float box_area(float y1, float x1, float y2, float x2) {
  return fmaxf(y2 - y1, 0.0f) * fmaxf(x2 - x1, 0.0f);
}
__device__ __forceinline__ float box_area(float4 b) { return box_area(b.x, b.y, b.z, b.w); }

__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b, float area_b) {
  const float ih = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float iw = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  const float inter = ih * iw;
  return inter / fmaxf(area_a + area_b - inter, 1e-8f);
}

// box_iou(a, b) > thr, without the division where the boxes do not overlap:
// there the intersection is +-0 and box_iou returns +-0 exactly (its
// denominator is at least 1e-8), so the answer is 0 > thr, bit for bit the
// same decision.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b,
                                          float thr) {
  const float ih = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float iw = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  if (ih * iw == 0.0f) return 0.0f > thr;
  return box_iou(a, area_a, b, area_b) > thr;
}

__device__ __forceinline__ uint32_t lane_id() {
  uint32_t lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  return lane;
}

// A round of greedy NMS over a chunk of 32 candidates in score order gives
// one warp to each candidate. The warp of candidate w (box v, area a; all
// 32 lanes call with the same values) builds w's row over the chunk (cbox,
// carea: the chunk's 32 boxes) in one ballot: bit j < w set when candidate
// j, if kept, suppresses w.
__device__ __forceinline__ uint32_t chunk_row(float4 v, float a, const float4* cbox,
                                              const float* carea, int w, float thr) {
  const int lane = lane_id();
  return __ballot_sync(0xffffffffu, lane < w && iou_above(v, a, cbox[lane], carea[lane], thr));
}

// ... and tests it against the `kept` boxes kept before the chunk, 32 a step
// (one a lane), stopping at the first step with a hit (one vote a step).
__device__ __forceinline__ bool kept_suppresses(float4 v, float a, const float4* kbox,
                                                const float* karea, int kept, float thr) {
  const int lane = lane_id();
  int hit = 0;
  for (int k0 = 0; k0 < kept && !hit; k0 += 32) {
    const int k = k0 + lane;
    hit = __any_sync(0xffffffffu, k < kept && iou_above(v, a, kbox[k], karea[k], thr));
  }
  return hit;
}

// Greedy NMS over one chunk of up to 32 candidates in score order, resolved
// by one warp (all 32 lanes call it with the same `alive` and `room`).
// alive: bit i set when candidate i is a candidate and no box kept before the
// chunk suppresses it. row (lane i's value): bit j < i set when candidate j,
// if kept, suppresses candidate i. Candidate i is kept when alive and no
// candidate kept earlier in the chunk suppresses it. That keep set is the
// unique fixpoint of keep_i = alive_i && !(row_i & keep) (bit i depends on
// bits below i only), reached from keep = alive in one ballot per step of
// the longest suppression chain in the chunk (at most 32 steps); then only
// the first `room` keeps stay. Returns the kept mask.
__device__ __forceinline__ uint32_t chunk_walk(uint32_t alive, uint32_t row, int room) {
  const bool mine = (alive >> lane_id()) & 1u;
  uint32_t keep = alive, prev;
  do {
    prev = keep;
    keep = __ballot_sync(0xffffffffu, mine && !(row & keep));
  } while (keep != prev);
  while (__popc(keep) > room) keep ^= 1u << (31 - __clz(keep));  // drop the last keeps
  return keep;
}
