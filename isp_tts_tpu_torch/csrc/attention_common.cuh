// Device helpers shared by the attention kernels (mqa_bwd.cu, flash_bwd.cu,
// and the forward kernels through attention_fwd.cuh): the dropout keep
// hash, the ALiBi distance, and widening loads / narrowing stores between
// the input type and f32.
//
// Every .cu file that includes this header is its own translation unit, so
// the helpers sit in an anonymous namespace there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The JAX package's _keep_hash (isp_tts_tpu/ops/flash_attention.py): keep
// iff the top byte of the hash of (idx + seed) is below thresh. All in
// uint32 arithmetic, so an index past 2^32 wraps as the int32 index does
// there. The hash is keep_mix((idx + seed) * KEEP_MUL): the first product
// is linear in idx, so a loop over consecutive keys can step it by KEEP_MUL.
constexpr uint32_t KEEP_MUL = 2654435761u;

__device__ __forceinline__ uint32_t keep_mix(uint32_t u) {
  u ^= u >> 17;
  return u * 0x45D9F3Bu;
}

__device__ __forceinline__ bool keep_bit(uint32_t idx, uint32_t seed,
                                         uint32_t thresh) {
  return (keep_mix((idx + seed) * KEEP_MUL) >> 24) < thresh;
}

// The ALiBi distance of key c from query n: -|c - n - offset|. The bias is
// this times the lower slope where c <= n + offset, else the upper one.
__device__ __forceinline__ float alibi_dist(int c, int n, int offset) {
  return -fabsf(static_cast<float>(c - n - offset));
}

// Eight consecutive elements as f32 (16- or 32-byte aligned source).
__device__ __forceinline__ void widen8(const float* src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void widen8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

}  // namespace
