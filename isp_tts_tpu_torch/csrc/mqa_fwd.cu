// Folded multi-query attention forward with in-kernel learned-ALiBi bias.
//
// Replaces the TPU kernel isp_tts_tpu/ops/flash_attention.py:_mqa_fwd_kernel
// (wrapper _mqa_fwd). Query rows are folded: row r = n * H + h of the
// (B, N*H, 64) view of q attends the one shared (B, M, 64) key/value head.
// The bias is recomputed from the per-head slopes, never read from memory:
//   dist = -|c - n - offset|,  bias = (c <= n + offset ? lo[h] : hi[h]) * dist
// Keys at or past key_lens[b] are masked, and with `causal` so are keys past
// n + offset. Rows with n >= q_lens[b], or that saw no valid key, write
// o = 0 and lse = +inf, as the TPU kernel does.
//
// What bounds it on an H100: at the serving shapes (N = M <= 2048, D = 64)
// it does 4*D operations per (row, key) pair against 2*D*bytes of K/V per
// key, so the fold of H heads onto one K/V head is what keeps it off the
// memory roof; in f32 it is bound by the CUDA-core FMA rate. The design:
// one block of BR threads per (batch, tile of BR folded rows), one thread
// per row holding its q row and f32 accumulator in registers; each K/V tile
// of BK keys is staged in shared memory once and read by all BR rows, i.e.
// by every head of BR/H queries. Softmax is online, in f32, in chunks of CK
// keys. bf16 inputs are widened to f32 as they are staged.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;    // head dim (every recipe)
constexpr int BR = 64;   // folded rows per block = threads per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int CK = 16;   // keys per online-softmax step
constexpr float NEG_INF = -1e30f;

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

template <typename T>
__global__ void __launch_bounds__(BR)
mqa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ slopes,
               const int* __restrict__ key_lens, const int* __restrict__ q_lens,
               T* __restrict__ o, float* __restrict__ lse, int N, int M, int H,
               int offset, int causal, float scale) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int b = blockIdx.y;
  const int R = N * H;
  const int r0 = blockIdx.x * BR;
  const int r = r0 + threadIdx.x;
  const bool in_range = r < R;
  const int n = r / H;
  const int h = r - n * H;
  const int key_len = min(key_lens[b], M);
  const bool live_q = in_range && n < q_lens[b];
  const float lo = in_range ? slopes[h] : 0.f;
  const float hi = in_range ? slopes[H + h] : 0.f;
  // this row's valid keys are [0, lim)
  const int lim = causal ? min(key_len, max(n + offset + 1, 0)) : key_len;

  // keys the block as a whole needs (block-uniform: bounds the tile loop)
  int kend = key_len;
  if (causal) {
    const int n_last = (min(r0 + BR, R) - 1) / H;
    kend = min(kend, max(n_last + offset + 1, 0));
  }

  float qr[D];
  float acc[D];
  if (live_q) {
    const T* qp = q + ((size_t)b * R + r) * D;
#pragma unroll
    for (int d = 0; d < D; d += 8) widen8(qp + d, qr + d);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  const T* kb = k + (size_t)b * M * D;
  const T* vb = v + (size_t)b * M * D;
  for (int c0 = 0; c0 < kend; c0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x * 8; i < BK * D; i += BR * 8) {
      const int j = i / D;
      const int d = i - j * D;
      const int c = c0 + j;
      if (c < M) {
        widen8(kb + (size_t)c * D + d, &ks[j][d]);
        widen8(vb + (size_t)c * D + d, &vs[j][d]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ks[j][d + e] = 0.f;
          vs[j][d + e] = 0.f;
        }
      }
    }
    __syncthreads();
    if (!live_q) continue;
    for (int j0 = 0; j0 < BK && c0 + j0 < lim; j0 += CK) {
      float s[CK];
      float mt = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < CK; ++jj) {
        const int c = c0 + j0 + jj;
        const float4* kr = reinterpret_cast<const float4*>(ks[j0 + jj]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kv = kr[d4];
          dot = fmaf(qr[4 * d4], kv.x, dot);
          dot = fmaf(qr[4 * d4 + 1], kv.y, dot);
          dot = fmaf(qr[4 * d4 + 2], kv.z, dot);
          dot = fmaf(qr[4 * d4 + 3], kv.w, dot);
        }
        const float dist = -fabsf((float)(c - n - offset));
        const float slope = (c <= n + offset) ? lo : hi;
        const float val = dot * scale + slope * dist;
        s[jj] = (c < lim) ? val : NEG_INF;
        mt = fmaxf(mt, s[jj]);
      }
      const float m_new = fmaxf(m, mt);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CK; ++jj) {
        const float p = (c0 + j0 + jj < lim) ? expf(s[jj] - m_new) : 0.f;
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[j0 + jj]);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!in_range) return;
  const bool ok = live_q && l > 0.f;
  const float inv_l = ok ? 1.f / l : 0.f;
  T* op = o + ((size_t)b * R + r) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) store1(op + d, acc[d] * inv_l);
  lse[(size_t)b * R + r] = ok ? m + logf(l) : INFINITY;
}

}  // namespace

extern "C" int isp_mqa_fwd(const void* q, const void* k, const void* v,
                           const void* slopes, const void* key_lens,
                           const void* q_lens, void* o, void* lse, int B, int N,
                           int M, int H, int offset, int causal, float scale,
                           int dtype, void* stream) {
  const dim3 grid((N * H + BR - 1) / BR, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    mqa_fwd_kernel<float><<<grid, BR, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(slopes),
        static_cast<const int*>(key_lens), static_cast<const int*>(q_lens),
        static_cast<float*>(o), static_cast<float*>(lse), N, M, H, offset,
        causal, scale);
  } else if (dtype == 1) {
    mqa_fwd_kernel<__nv_bfloat16><<<grid, BR, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const float*>(slopes), static_cast<const int*>(key_lens),
        static_cast<const int*>(q_lens), static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), N, M, H, offset, causal, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
