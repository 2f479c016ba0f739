// Per-head streaming attention forward with in-kernel learned-ALiBi bias,
// key/query lengths, causal masking and probability dropout.
//
// Replaces the TPU kernel isp_tts_tpu/ops/flash_attention.py:_fwd_kernel
// (wrapper _flash_fwd, entry flash_attention), the core of every
// self-attention layer with one key/value head per query head. Layouts are
// the projections' own: q and o (B, N, H, 64), k and v (B, M, Hkv, 64) with
// Hkv = H, or Hkv = 1 (every head reads the one key/value head).
// The bias is recomputed from the per-head slopes, never read from memory:
//   dist = -|c - n - offset|,  bias = (c <= n + offset ? lo[h] : hi[h]) * dist
// Keys at or past key_lens[b] are masked, and with `causal` so are keys past
// n + offset. Rows with n >= q_lens[b], or that saw no valid key, write
// o = 0 and lse = +inf, as the TPU kernel does, so the backward
// (flash_bwd.cu) recomputes p = exp(s - lse) = 0 there with no special case.
//
// Dropout (thresh < 256) acts on the post-softmax probabilities: the
// normaliser l sums the undropped p, the value product the dropped ones.
// The keep bit of (b, h, n, c) is the TPU kernel's _head_keep: the hash of
// the index ((b*H + h)*N + n)*M + c plus the seed, in uint32 arithmetic, so
// the backward regenerates it bit for bit.
//
// What bounds it on an H100: 4*D operations per (live query, valid key)
// pair against the K/V bytes of each key, read once per block of BQ
// queries; at the serving and training shapes (N = M <= 3072, D = 64) it is
// bound by the CUDA cores' f32 FMA rate (no tensor cores yet). The design:
// one block of BQ threads per (batch, head, tile of BQ queries), one thread
// per query row holding its q row and f32 accumulator in registers; each
// K/V tile of BK keys is staged in shared memory once and read by all BQ
// rows. Softmax is online, in f32, in chunks of CK keys. Key tiles past the
// key length, and under `causal` past the block's last query, are never
// loaded; a block of dead rows loads none. bf16 inputs are widened to f32
// as they are staged.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include "attention_common.cuh"

namespace {

constexpr int D = 64;    // head dim (every recipe)
constexpr int BQ = 64;   // queries per block = threads per block
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int CK = 16;   // keys per online-softmax step
constexpr float NEG_INF = -1e30f;

template <typename T>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ slopes,
                 const int* __restrict__ key_lens,
                 const int* __restrict__ q_lens,
                 const int* __restrict__ seed_ptr, T* __restrict__ o,
                 float* __restrict__ lse, int N, int M, int H, int Hkv,
                 int offset, int causal, float scale, int thresh,
                 float inv_keep) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int n0 = blockIdx.x * BQ;
  const int n = n0 + threadIdx.x;
  const int hk = Hkv == 1 ? 0 : h;
  const int key_len = min(key_lens[b], M);
  const int q_len = min(q_lens[b], N);
  const bool live_q = n < q_len;
  const float lo = slopes[h];
  const float hi = slopes[H + h];
  // this row's valid keys are [0, lim)
  const int lim = causal ? min(key_len, max(n + offset + 1, 0)) : key_len;
  // keys the block as a whole needs (block-uniform: bounds the tile loop)
  int kend = n0 < q_len ? key_len : 0;
  if (causal) {
    const int n_last = min(n0 + BQ, q_len) - 1;
    kend = min(kend, max(n_last + offset + 1, 0));
  }
  const bool drop = thresh < 256;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  // hash index of (b, h, n, key 0); uint32 wrap as the TPU kernel's int32
  const uint32_t idx0 =
      ((static_cast<uint32_t>(b) * static_cast<uint32_t>(H) +
        static_cast<uint32_t>(h)) * static_cast<uint32_t>(N) +
       static_cast<uint32_t>(n)) * static_cast<uint32_t>(M);
  const size_t row = (static_cast<size_t>(b) * N + n) * H + h;

  float qr[D];
  float acc[D];
  if (live_q) {
    const T* qp = q + row * D;
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

  // key c of this head starts at kb + c * Hkv * D
  const T* kb = k + (static_cast<size_t>(b) * M * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * M * Hkv + hk) * D;
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  for (int c0 = 0; c0 < kend; c0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x * 8; i < BK * D; i += BQ * 8) {
      const int j = i / D;
      const int d = i - j * D;
      const int c = c0 + j;
      if (c < M) {
        widen8(kb + c * kstride + d, &ks[j][d]);
        widen8(vb + c * kstride + d, &vs[j][d]);
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
        const float slope = (c <= n + offset) ? lo : hi;
        const float val = dot * scale + slope * alibi_dist(c, n, offset);
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
        const int c = c0 + j0 + jj;
        float p = (c < lim) ? expf(s[jj] - m_new) : 0.f;
        l += p;
        if (drop) {
          p = keep_bit(idx0 + static_cast<uint32_t>(c), seed,
                       static_cast<uint32_t>(thresh)) ? p * inv_keep : 0.f;
        }
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

  if (n >= N) return;
  const bool ok = live_q && l > 0.f;
  const float inv_l = ok ? 1.f / l : 0.f;
  T* op = o + row * D;
#pragma unroll
  for (int d = 0; d < D; ++d) store1(op + d, acc[d] * inv_l);
  lse[(static_cast<size_t>(b) * H + h) * N + n] = ok ? m + logf(l) : INFINITY;
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* slopes,
            const void* key_lens, const void* q_lens, const void* seed,
            void* o, void* lse, int B, int N, int M, int H, int Hkv,
            int offset, int causal, float scale, int thresh, float inv_keep,
            cudaStream_t st) {
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, BQ, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(slopes),
      static_cast<const int*>(key_lens), static_cast<const int*>(q_lens),
      static_cast<const int*>(seed), static_cast<T*>(o),
      static_cast<float*>(lse), N, M, H, Hkv, offset, causal, scale, thresh,
      inv_keep);
}

}  // namespace

extern "C" int isp_flash_fwd(const void* q, const void* k, const void* v,
                             const void* slopes, const void* key_lens,
                             const void* q_lens, const void* seed, void* o,
                             void* lse, int B, int N, int M, int H, int Hkv,
                             int offset, int causal, float scale, int thresh,
                             float inv_keep, int dtype, void* stream) {
  if (H > 65535 || B > 65535 || !(Hkv == 1 || Hkv == H)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(q, k, v, slopes, key_lens, q_lens, seed, o, lse, B, N, M, H,
                  Hkv, offset, causal, scale, thresh, inv_keep, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, slopes, key_lens, q_lens, seed, o, lse, B,
                          N, M, H, Hkv, offset, causal, scale, thresh,
                          inv_keep, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
