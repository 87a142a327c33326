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
