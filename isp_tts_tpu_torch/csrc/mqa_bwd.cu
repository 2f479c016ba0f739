// Folded multi-query attention backward with in-kernel learned-ALiBi bias
// and probability dropout.
//
// Replaces the TPU kernels isp_tts_tpu/ops/flash_attention.py:
// _mqa_dfused_kernel (wrapper _mqa_bwd_fused, used while the key axis fits
// resident, M <= 2048) and _mqa_dq_kernel + _mqa_dkv_kernel (wrapper
// _mqa_bwd, key-streamed above that). Those are one function under two TPU
// VMEM policies; on Hopper one design serves both, since every pass here
// streams its other axis through shared memory and has no resident limit.
//
// Rows are folded as in the forward (mqa_fwd.cu): row r = n * H + h of the
// (B, N*H, 64) view of q and dO reads the one shared (B, M, 64) key/value
// head. From the forward's o and lse (+inf on dead rows, so p = 0 there):
//   delta = rowsum(dO * O)              p  = exp(s - lse)
//   dp    = dO . v (* keep / (1-rate))  ds = p * (dp - delta)
//   dv    = sum_rows p * keep/(1-rate) * dO
//   dq    = scale * ds . k              dk = scale * sum_rows ds * q
//   dslope[lower|upper][h] = sum ds * dist over that triangle
// The keep bit is the forward's hash of the folded index (b*R + r)*M + c.
//
// What bounds it on an H100: 10*D operations per (live row, valid key) pair
// against (3 + 4) row vectors and 2 key vectors of bytes, so at the
// training shapes it is operation-bound, on the f32 CUDA-core rate (no
// tensor cores yet). The design, three launches on the caller's stream:
//   1. dq pass: one block of BR threads per (batch, tile of BR folded
//      rows), one thread per row holding q, dO and its dq accumulator in
//      registers; K/V tiles of BK keys are staged in shared memory once and
//      read by all BR rows. It also writes delta for pass 2 and reduces the
//      slope gradients per head in shared memory, then one float atomic per
//      head and block.
//   2. dk/dv pass: one block of BC threads per (batch, tile of BC keys,
//      split of the row range), one thread per key holding its dk and dv
//      accumulators in registers; the key tile sits transposed in shared
//      memory (conflict-free per-thread reads), q/dO rows stream through in
//      tiles of TR and are read as broadcasts. Each split writes a partial
//      sum to an f32 workspace: the row range is split so the grid covers
//      the card, and the sum stays deterministic (no atomics).
//   3. a reduction over the splits that writes dk and dv in the input type.
// bf16 inputs are widened to f32 as they are staged; all sums are f32.
//
// Plain C interface for ctypes; returns the first launch's cudaGetLastError.

#include "attention_common.cuh"

namespace {

constexpr int D = 64;     // head dim (every recipe)
constexpr int BR = 64;    // dq pass: folded rows per block = threads
constexpr int BK = 64;    // dq pass: keys per shared-memory tile
constexpr int BC = 64;    // dk/dv pass: keys per block = threads
constexpr int TR = 16;    // dk/dv pass: rows per shared-memory tile
constexpr int MAXH = 64;  // heads the slope reduction holds

// ---------------------------------------------------------------- pass 1
template <typename T>
__global__ void __launch_bounds__(BR)
mqa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ slopes,
              const int* __restrict__ key_lens, const int* __restrict__ q_lens,
              const int* __restrict__ seed_ptr, const T* __restrict__ o,
              const float* __restrict__ lse, const T* __restrict__ dout,
              T* __restrict__ dq, float* __restrict__ dslopes,
              float* __restrict__ delta_out, int N, int M, int H, int offset,
              int causal, float scale, int thresh, float inv_keep) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ float dsl[2][MAXH];

  const int b = blockIdx.y;
  const int R = N * H;
  const int r0 = blockIdx.x * BR;
  const int r = r0 + threadIdx.x;
  const bool in_range = r < R;
  const int n = r / H;
  const int h = r - n * H;
  const int key_len = min(key_lens[b], M);
  const size_t row = static_cast<size_t>(b) * R + r;
  const float L = in_range ? lse[row] : INFINITY;
  const bool live = in_range && n < q_lens[b] && L < INFINITY;
  const float lo = in_range ? slopes[h] : 0.f;
  const float hi = in_range ? slopes[H + h] : 0.f;
  const int lim = causal ? min(key_len, max(n + offset + 1, 0)) : key_len;
  int kend = key_len;
  if (causal) {
    const int n_last = (min(r0 + BR, R) - 1) / H;
    kend = min(kend, max(n_last + offset + 1, 0));
  }
  const bool drop = thresh < 256;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const uint32_t idx0 = (static_cast<uint32_t>(b) * static_cast<uint32_t>(R) +
                         static_cast<uint32_t>(r)) * static_cast<uint32_t>(M);

  for (int i = threadIdx.x; i < 2 * MAXH; i += BR) dsl[i / MAXH][i % MAXH] = 0.f;

  float qr[D];
  float dor[D];
  float acc[D];
  float delta = 0.f;
  if (in_range) {
    const T* dp = dout + row * D;
    const T* op = o + row * D;
#pragma unroll
    for (int d = 0; d < D; d += 8) {
      float of[8];
      widen8(dp + d, dor + d);
      widen8(op + d, of);
#pragma unroll
      for (int e = 0; e < 8; ++e) delta = fmaf(dor[d + e], of[e], delta);
    }
    delta_out[row] = delta;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) dor[d] = 0.f;
  }
  if (live) {
    const T* qp = q + row * D;
#pragma unroll
    for (int d = 0; d < D; d += 8) widen8(qp + d, qr + d);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float slo = 0.f;
  float shi = 0.f;

  const T* kb = k + static_cast<size_t>(b) * M * D;
  const T* vb = v + static_cast<size_t>(b) * M * D;
  for (int c0 = 0; c0 < kend; c0 += BK) {
    __syncthreads();  // previous tile fully consumed (and dsl zeroed)
    for (int i = threadIdx.x * 8; i < BK * D; i += BR * 8) {
      const int j = i / D;
      const int d = i - j * D;
      const int c = c0 + j;
      if (c < M) {
        widen8(kb + static_cast<size_t>(c) * D + d, &ks[j][d]);
        widen8(vb + static_cast<size_t>(c) * D + d, &vs[j][d]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ks[j][d + e] = 0.f;
          vs[j][d + e] = 0.f;
        }
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < BK && c0 + j < lim; ++j) {
      const int c = c0 + j;
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
      float sd = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
        const float4 vv = vr[d4];
        sd = fmaf(qr[4 * d4], kv.x, sd);
        sd = fmaf(qr[4 * d4 + 1], kv.y, sd);
        sd = fmaf(qr[4 * d4 + 2], kv.z, sd);
        sd = fmaf(qr[4 * d4 + 3], kv.w, sd);
        dp = fmaf(dor[4 * d4], vv.x, dp);
        dp = fmaf(dor[4 * d4 + 1], vv.y, dp);
        dp = fmaf(dor[4 * d4 + 2], vv.z, dp);
        dp = fmaf(dor[4 * d4 + 3], vv.w, dp);
      }
      const float dist = alibi_dist(c, n, offset);
      const bool lower = c <= n + offset;
      const float p = expf(sd * scale + (lower ? lo : hi) * dist - L);
      if (drop) {
        dp = keep_bit(idx0 + static_cast<uint32_t>(c), seed,
                      static_cast<uint32_t>(thresh)) ? dp * inv_keep : 0.f;
      }
      const float ds = p * (dp - delta);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kv = kr[d4];
        acc[4 * d4] = fmaf(ds, kv.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(ds, kv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(ds, kv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(ds, kv.w, acc[4 * d4 + 3]);
      }
      if (lower) {
        slo = fmaf(ds, dist, slo);
      } else {
        shi = fmaf(ds, dist, shi);
      }
    }
  }
  __syncthreads();  // dsl zeroed even when no key tile ran
  if (in_range) {
    T* qp = dq + row * D;
#pragma unroll
    for (int d = 0; d < D; ++d) store1(qp + d, live ? acc[d] * scale : 0.f);
  }
  if (live) {
    atomicAdd(&dsl[0][h], slo);
    atomicAdd(&dsl[1][h], shi);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H; i += BR) {
    atomicAdd(&dslopes[i], dsl[0][i]);
    atomicAdd(&dslopes[H + i], dsl[1][i]);
  }
}

// ---------------------------------------------------------------- pass 2
template <typename T>
__global__ void __launch_bounds__(BC)
mqa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ slopes,
               const int* __restrict__ key_lens, const int* __restrict__ q_lens,
               const int* __restrict__ seed_ptr, const float* __restrict__ lse,
               const T* __restrict__ dout, const float* __restrict__ delta,
               float* __restrict__ work, int B, int N, int M, int H,
               int offset, int causal, float scale, int thresh,
               float inv_keep) {
  __shared__ __align__(16) float kt[D][BC];  // transposed key tile
  __shared__ __align__(16) float vt[D][BC];
  __shared__ __align__(16) float qs[TR][D];
  __shared__ __align__(16) float gs[TR][D];  // dO rows
  __shared__ float ls[TR];
  __shared__ float dl[TR];
  __shared__ float slo_s[MAXH];
  __shared__ float shi_s[MAXH];

  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int R = N * H;
  const int c0 = blockIdx.x * BC;
  const int c = c0 + threadIdx.x;
  const int key_len = min(key_lens[b], M);
  const int q_len = min(q_lens[b], N);
  const bool valid_key = c < key_len;
  const bool drop = thresh < 256;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);

  for (int i = threadIdx.x; i < H; i += BC) {
    slo_s[i] = slopes[i];
    shi_s[i] = slopes[H + i];
  }
  const T* kb = k + static_cast<size_t>(b) * M * D;
  const T* vb = v + static_cast<size_t>(b) * M * D;
  for (int i = threadIdx.x * 8; i < BC * D; i += BC * 8) {
    const int j = i / D;
    const int d = i - j * D;
    float kf[8];
    float vf[8];
    if (c0 + j < M) {
      widen8(kb + static_cast<size_t>(c0 + j) * D + d, kf);
      widen8(vb + static_cast<size_t>(c0 + j) * D + d, vf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      kt[d + e][j] = kf[e];
      vt[d + e][j] = vf[e];
    }
  }

  // rows that can reach this key tile: live queries only, and under the
  // causal mask only queries n >= c0 - offset
  int rs = causal ? max(c0 - offset, 0) * H : 0;
  int re = q_len * H;
  if (c0 >= key_len) re = rs;  // no valid key in the tile
  const int total = max(re - rs, 0);
  const int chunk = (total + splits - 1) / splits;
  const int my_start = rs + split * chunk;
  const int my_end = min(re, my_start + chunk);

  float dk[D];
  float dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;

  const size_t base = static_cast<size_t>(b) * R;
  for (int t0 = my_start; t0 < my_end; t0 += TR) {
    __syncthreads();  // previous row tile fully consumed (and kt/vt staged)
    for (int i = threadIdx.x * 8; i < TR * D; i += BC * 8) {
      const int j = i / D;
      const int d = i - j * D;
      const int r = t0 + j;
      if (r < my_end) {
        widen8(q + (base + r) * D + d, &qs[j][d]);
        widen8(dout + (base + r) * D + d, &gs[j][d]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qs[j][d + e] = gs[j][d + e] = 0.f;
      }
    }
    if (threadIdx.x < TR) {
      const int r = t0 + threadIdx.x;
      ls[threadIdx.x] = r < my_end ? lse[base + r] : INFINITY;
      dl[threadIdx.x] = r < my_end ? delta[base + r] : 0.f;
    }
    __syncthreads();
    if (!valid_key) continue;
    for (int i = 0; i < TR; ++i) {
      const float L = ls[i];
      if (!(L < INFINITY)) continue;  // dead row or past the range
      const int r = t0 + i;
      const int n = r / H;
      const int h = r - n * H;
      if (causal && c > n + offset) continue;
      const float4* qr = reinterpret_cast<const float4*>(qs[i]);
      const float4* gr = reinterpret_cast<const float4*>(gs[i]);
      float sd = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = qr[d4];
        const float4 gv = gr[d4];
        sd = fmaf(qv.x, kt[4 * d4][threadIdx.x], sd);
        sd = fmaf(qv.y, kt[4 * d4 + 1][threadIdx.x], sd);
        sd = fmaf(qv.z, kt[4 * d4 + 2][threadIdx.x], sd);
        sd = fmaf(qv.w, kt[4 * d4 + 3][threadIdx.x], sd);
        dp = fmaf(gv.x, vt[4 * d4][threadIdx.x], dp);
        dp = fmaf(gv.y, vt[4 * d4 + 1][threadIdx.x], dp);
        dp = fmaf(gv.z, vt[4 * d4 + 2][threadIdx.x], dp);
        dp = fmaf(gv.w, vt[4 * d4 + 3][threadIdx.x], dp);
      }
      const float dist = alibi_dist(c, n, offset);
      const float slope = (c <= n + offset) ? slo_s[h] : shi_s[h];
      const float p = expf(sd * scale + slope * dist - L);
      float mf = 1.f;
      if (drop) {
        const uint32_t idx = (static_cast<uint32_t>(b) * static_cast<uint32_t>(R) +
                              static_cast<uint32_t>(r)) * static_cast<uint32_t>(M) +
                             static_cast<uint32_t>(c);
        mf = keep_bit(idx, seed, static_cast<uint32_t>(thresh)) ? inv_keep : 0.f;
      }
      const float pv = p * mf;
      const float ds = p * (dp * mf - dl[i]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = qr[d4];
        const float4 gv = gr[d4];
        dv[4 * d4] = fmaf(pv, gv.x, dv[4 * d4]);
        dv[4 * d4 + 1] = fmaf(pv, gv.y, dv[4 * d4 + 1]);
        dv[4 * d4 + 2] = fmaf(pv, gv.z, dv[4 * d4 + 2]);
        dv[4 * d4 + 3] = fmaf(pv, gv.w, dv[4 * d4 + 3]);
        dk[4 * d4] = fmaf(ds, qv.x, dk[4 * d4]);
        dk[4 * d4 + 1] = fmaf(ds, qv.y, dk[4 * d4 + 1]);
        dk[4 * d4 + 2] = fmaf(ds, qv.z, dk[4 * d4 + 2]);
        dk[4 * d4 + 3] = fmaf(ds, qv.w, dk[4 * d4 + 3]);
      }
    }
  }
  if (c >= M) return;
  // partial sums of this split: work[split][0 = dk | 1 = dv][b][c][:]
  const size_t plane = static_cast<size_t>(B) * M * D;
  float* wk = work + (static_cast<size_t>(split) * 2) * plane +
              (static_cast<size_t>(b) * M + c) * D;
  float* wv = wk + plane;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    reinterpret_cast<float4*>(wk)[d4] =
        make_float4(dk[4 * d4], dk[4 * d4 + 1], dk[4 * d4 + 2], dk[4 * d4 + 3]);
    reinterpret_cast<float4*>(wv)[d4] =
        make_float4(dv[4 * d4], dv[4 * d4 + 1], dv[4 * d4 + 2], dv[4 * d4 + 3]);
  }
}

// ---------------------------------------------------------------- pass 3
template <typename T>
__global__ void dkv_reduce_kernel(const float* __restrict__ work,
                                  T* __restrict__ dk, T* __restrict__ dv,
                                  size_t plane, int splits, float scale) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float sk = 0.f;
  float sv = 0.f;
  for (int s = 0; s < splits; ++s) {
    sk += work[(static_cast<size_t>(s) * 2) * plane + i];
    sv += work[(static_cast<size_t>(s) * 2 + 1) * plane + i];
  }
  store1(dk + i, sk * scale);
  store1(dv + i, sv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* slopes,
           const void* key_lens, const void* q_lens, const void* seed,
           const void* o, const void* lse, const void* dout, void* dq, void* dk,
           void* dv, void* dslopes, void* delta, void* work, int B, int N,
           int M, int H, int offset, int causal, float scale, int thresh,
           float inv_keep, int splits, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* sl = static_cast<const float*>(slopes);
  const int* kl = static_cast<const int*>(key_lens);
  const int* ql = static_cast<const int*>(q_lens);
  const int* sd = static_cast<const int*>(seed);
  mqa_dq_kernel<T><<<dim3((N * H + BR - 1) / BR, B), BR, 0, st>>>(
      qt, kt, vt, sl, kl, ql, sd, static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(dslopes),
      static_cast<float*>(delta), N, M, H, offset, causal, scale, thresh,
      inv_keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mqa_dkv_kernel<T><<<dim3((M + BC - 1) / BC, B, splits), BC, 0, st>>>(
      qt, kt, vt, sl, kl, ql, sd, static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(delta),
      static_cast<float*>(work), B, N, M, H, offset, causal, scale, thresh,
      inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t plane = static_cast<size_t>(B) * M * D;
  dkv_reduce_kernel<T><<<static_cast<unsigned>((plane + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(work), static_cast<T*>(dk), static_cast<T*>(dv),
      plane, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int isp_mqa_bwd(const void* q, const void* k, const void* v,
                           const void* slopes, const void* key_lens,
                           const void* q_lens, const void* seed, const void* o,
                           const void* lse, const void* dout, void* dq, void* dk,
                           void* dv, void* dslopes, void* delta, void* work,
                           int B, int N, int M, int H, int offset, int causal,
                           float scale, int thresh, float inv_keep, int splits,
                           int dtype, void* stream) {
  if (H > MAXH || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, slopes, key_lens, q_lens, seed, o, lse, dout,
                         dq, dk, dv, dslopes, delta, work, B, N, M, H, offset,
                         causal, scale, thresh, inv_keep, splits, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, slopes, key_lens, q_lens, seed, o, lse,
                                 dout, dq, dk, dv, dslopes, delta, work, B, N, M,
                                 H, offset, causal, scale, thresh, inv_keep,
                                 splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
