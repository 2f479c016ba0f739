// bf16 for the CPU emulation: round to nearest even, as the CUDA intrinsics.
#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { uint16_t u; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(uint32_t(b.u) << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
inline float2 __bfloat1622float2(__nv_bfloat162 v) { return {__bfloat162float(v.x), __bfloat162float(v.y)}; }
