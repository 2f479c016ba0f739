// Per-head streaming attention backward with in-kernel learned-ALiBi bias
// and probability dropout.
//
// Replaces the TPU kernels isp_tts_tpu/ops/flash_attention.py:_dq_kernel
// and _dkv_kernel (wrapper _flash_bwd): the backward of flash_fwd.cu, with
// the same layouts (q, o, dO, dq (B, N, H, 64); k, v, dk, dv
// (B, M, Hkv, 64), Hkv = H or 1). From the forward's o and lse (+inf on
// dead rows, so p = 0 there):
//   delta = rowsum(dO * O)              p  = exp(s - lse)
//   dp    = dO . v (* keep / (1-rate))  ds = p * (dp - delta)
//   dv    = sum_n p * keep/(1-rate) * dO
//   dq    = scale * ds . k              dk = scale * sum_n ds * q
//   dslope[lower|upper][h] = sum ds * dist over that triangle
// The keep bit is the forward's hash of ((b*H + h)*N + n)*M + c.
//
// What bounds it on an H100: 10*D operations per (live query, valid key)
// pair, against the bytes of q, o, dO, dq (per query row) and k, v, dk, dv
// (per key row), so at the training shapes it is bound by the CUDA cores'
// f32 FMA rate (no tensor cores yet). The design, two or three launches on
// the caller's stream:
//   1. dq pass: one block of BQ threads per (batch, head, tile of BQ
//      queries), one thread per query holding q and its dq accumulator in
//      registers and its dO row in shared memory (rows padded to D + 4
//      floats, so the per-thread float4 reads are conflict-free); K/V tiles
//      of BK keys are staged in shared memory once and read by all BQ rows.
//      It writes delta for pass 2, and reduces the slope gradients over the
//      block's rows in shared memory in a fixed order, then issues one
//      float atomic per (head, block) and triangle.
//   2. dk/dv pass: one block of BC threads per (batch, head, tile of BC
//      keys), one thread per key holding its dk and dv accumulators in
//      registers; the key tile sits transposed in shared memory
//      (conflict-free per-thread reads), the head's q/dO rows stream
//      through in tiles of TR and are read as broadcasts. With Hkv = H each
//      key belongs to one head and the pass writes dk and dv directly.
//   3. Hkv = 1 only: pass 2 writes per-head f32 partial sums to a
//      workspace, and a third launch sums them over the heads in a fixed
//      order into dk and dv. No float atomics touch dk or dv, so they are
//      deterministic.
// bf16 inputs are widened to f32 as they are staged; all sums are f32.
//
// Plain C interface for ctypes; returns the first failing launch's
// cudaGetLastError, else 0.

#include "attention_common.cuh"

namespace {

constexpr int D = 64;       // head dim (every recipe)
constexpr int DP = D + 4;   // padded row of the dq pass's dO tile
constexpr int BQ = 64;      // dq pass: queries per block = threads
constexpr int BK = 32;      // dq pass: keys per shared-memory tile (static
                            // shared memory stays under 48 KB with the dO rows)
constexpr int BC = 64;      // dk/dv pass: keys per block = threads
constexpr int TR = 16;      // dk/dv pass: query rows per shared-memory tile

// ---------------------------------------------------------------- pass 1
template <typename T>
__global__ void __launch_bounds__(BQ)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ slopes,
                const int* __restrict__ key_lens,
                const int* __restrict__ q_lens,
                const int* __restrict__ seed_ptr, const T* __restrict__ o,
                const float* __restrict__ lse, const T* __restrict__ dout,
                T* __restrict__ dq, float* __restrict__ dslopes,
                float* __restrict__ delta_out, int N, int M, int H, int Hkv,
                int offset, int causal, float scale, int thresh,
                float inv_keep) {
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ __align__(16) float gs[BQ][DP];  // this block's dO rows
  __shared__ float red[2][BQ];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int n0 = blockIdx.x * BQ;
  const int t = threadIdx.x;
  const int n = n0 + t;
  const bool in_range = n < N;
  const int hk = Hkv == 1 ? 0 : h;
  const int key_len = min(key_lens[b], M);
  const int q_len = min(q_lens[b], N);
  const size_t row = (static_cast<size_t>(b) * N + n) * H + h;
  const size_t lrow = (static_cast<size_t>(b) * H + h) * N + n;
  const float L = in_range ? lse[lrow] : INFINITY;
  const bool live = n < q_len && L < INFINITY;
  const float lo = slopes[h];
  const float hi = slopes[H + h];
  const int lim = causal ? min(key_len, max(n + offset + 1, 0)) : key_len;
  int kend = n0 < q_len ? key_len : 0;
  if (causal) {
    const int n_last = min(n0 + BQ, q_len) - 1;
    kend = min(kend, max(n_last + offset + 1, 0));
  }
  const bool drop = thresh < 256;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const uint32_t idx0 =
      ((static_cast<uint32_t>(b) * static_cast<uint32_t>(H) +
        static_cast<uint32_t>(h)) * static_cast<uint32_t>(N) +
       static_cast<uint32_t>(n)) * static_cast<uint32_t>(M);

  float* g = gs[t];
  float delta = 0.f;
  if (in_range) {
    const T* dp = dout + row * D;
    const T* op = o + row * D;
#pragma unroll
    for (int d = 0; d < D; d += 8) {
      float of[8];
      widen8(dp + d, g + d);
      widen8(op + d, of);
#pragma unroll
      for (int e = 0; e < 8; ++e) delta = fmaf(g[d + e], of[e], delta);
    }
    delta_out[lrow] = delta;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) g[d] = 0.f;
  }
  float qr[D];
  float acc[D];
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

  const T* kb = k + (static_cast<size_t>(b) * M * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * M * Hkv + hk) * D;
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  const float4* gr = reinterpret_cast<const float4*>(g);
  for (int c0 = 0; c0 < kend; c0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = t * 8; i < BK * D; i += BQ * 8) {
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
        const float4 gv = gr[d4];
        sd = fmaf(qr[4 * d4], kv.x, sd);
        sd = fmaf(qr[4 * d4 + 1], kv.y, sd);
        sd = fmaf(qr[4 * d4 + 2], kv.z, sd);
        sd = fmaf(qr[4 * d4 + 3], kv.w, sd);
        dp = fmaf(gv.x, vv.x, dp);
        dp = fmaf(gv.y, vv.y, dp);
        dp = fmaf(gv.z, vv.z, dp);
        dp = fmaf(gv.w, vv.w, dp);
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
  if (in_range) {
    T* qp = dq + row * D;
#pragma unroll
    for (int d = 0; d < D; ++d) store1(qp + d, live ? acc[d] * scale : 0.f);
  }
  // the block's slope gradients: a tree over its rows, in a fixed order
  red[0][t] = slo;
  red[1][t] = shi;
  for (int s = BQ / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (t < s) {
      red[0][t] += red[0][t + s];
      red[1][t] += red[1][t + s];
    }
  }
  if (t == 0 && n0 < q_len) {
    atomicAdd(&dslopes[h], red[0][0]);
    atomicAdd(&dslopes[H + h], red[1][0]);
  }
}

// ---------------------------------------------------------------- pass 2
template <typename T>
__global__ void __launch_bounds__(BC)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ slopes,
                 const int* __restrict__ key_lens,
                 const int* __restrict__ q_lens,
                 const int* __restrict__ seed_ptr,
                 const float* __restrict__ lse, const T* __restrict__ dout,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, float* __restrict__ work, int B, int N,
                 int M, int H, int Hkv, int offset, int causal, float scale,
                 int thresh, float inv_keep) {
  __shared__ __align__(16) float kt[D][BC];  // transposed key tile
  __shared__ __align__(16) float vt[D][BC];
  __shared__ __align__(16) float qs[TR][D];
  __shared__ __align__(16) float gs[TR][D];  // dO rows
  __shared__ float ls[TR];
  __shared__ float dl[TR];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int c0 = blockIdx.x * BC;
  const int t = threadIdx.x;
  const int c = c0 + t;
  const int hk = Hkv == 1 ? 0 : h;
  const int key_len = min(key_lens[b], M);
  const int q_len = min(q_lens[b], N);
  const bool valid_key = c < key_len;
  const float lo = slopes[h];
  const float hi = slopes[H + h];
  const bool drop = thresh < 256;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const uint32_t bh = static_cast<uint32_t>(b) * static_cast<uint32_t>(H) +
                      static_cast<uint32_t>(h);

  const T* kb = k + (static_cast<size_t>(b) * M * Hkv + hk) * D;
  const T* vb = v + (static_cast<size_t>(b) * M * Hkv + hk) * D;
  const size_t kstride = static_cast<size_t>(Hkv) * D;
  for (int i = t * 8; i < BC * D; i += BC * 8) {
    const int j = i / D;
    const int d = i - j * D;
    float kf[8];
    float vf[8];
    if (c0 + j < M) {
      widen8(kb + (c0 + j) * kstride + d, kf);
      widen8(vb + (c0 + j) * kstride + d, vf);
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

  // queries that can reach this key tile: live ones only, and under the
  // causal mask only n >= c0 - offset; none when the tile has no valid key
  const int rs = causal ? max(c0 - offset, 0) : 0;
  const int re = c0 < key_len ? q_len : rs;

  float dkr[D];
  float dvr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dkr[d] = dvr[d] = 0.f;

  const size_t qbase = static_cast<size_t>(b) * N * H + h;  // row (b, 0, h)
  const size_t lbase = static_cast<size_t>(bh) * N;
  for (int t0 = rs; t0 < re; t0 += TR) {
    __syncthreads();  // previous row tile fully consumed (and kt/vt staged)
    for (int i = t * 8; i < TR * D; i += BC * 8) {
      const int j = i / D;
      const int d = i - j * D;
      const int n = t0 + j;
      if (n < re) {
        const size_t r = (qbase + static_cast<size_t>(n) * H) * D + d;
        widen8(q + r, &qs[j][d]);
        widen8(dout + r, &gs[j][d]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qs[j][d + e] = gs[j][d + e] = 0.f;
      }
    }
    if (t < TR) {
      const int n = t0 + t;
      ls[t] = n < re ? lse[lbase + n] : INFINITY;
      dl[t] = n < re ? delta[lbase + n] : 0.f;
    }
    __syncthreads();
    if (!valid_key) continue;
    for (int i = 0; i < TR; ++i) {
      const float L = ls[i];
      if (!(L < INFINITY)) continue;  // dead row or past the range
      const int n = t0 + i;
      if (causal && c > n + offset) continue;
      const float4* qr = reinterpret_cast<const float4*>(qs[i]);
      const float4* gr = reinterpret_cast<const float4*>(gs[i]);
      float sd = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = qr[d4];
        const float4 gv = gr[d4];
        sd = fmaf(qv.x, kt[4 * d4][t], sd);
        sd = fmaf(qv.y, kt[4 * d4 + 1][t], sd);
        sd = fmaf(qv.z, kt[4 * d4 + 2][t], sd);
        sd = fmaf(qv.w, kt[4 * d4 + 3][t], sd);
        dp = fmaf(gv.x, vt[4 * d4][t], dp);
        dp = fmaf(gv.y, vt[4 * d4 + 1][t], dp);
        dp = fmaf(gv.z, vt[4 * d4 + 2][t], dp);
        dp = fmaf(gv.w, vt[4 * d4 + 3][t], dp);
      }
      const float slope = (c <= n + offset) ? lo : hi;
      const float p = expf(sd * scale + slope * alibi_dist(c, n, offset) - L);
      float mf = 1.f;
      if (drop) {
        const uint32_t idx = (bh * static_cast<uint32_t>(N) +
                              static_cast<uint32_t>(n)) * static_cast<uint32_t>(M) +
                             static_cast<uint32_t>(c);
        mf = keep_bit(idx, seed, static_cast<uint32_t>(thresh)) ? inv_keep : 0.f;
      }
      const float pv = p * mf;
      const float ds = p * (dp * mf - dl[i]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = qr[d4];
        const float4 gv = gr[d4];
        dvr[4 * d4] = fmaf(pv, gv.x, dvr[4 * d4]);
        dvr[4 * d4 + 1] = fmaf(pv, gv.y, dvr[4 * d4 + 1]);
        dvr[4 * d4 + 2] = fmaf(pv, gv.z, dvr[4 * d4 + 2]);
        dvr[4 * d4 + 3] = fmaf(pv, gv.w, dvr[4 * d4 + 3]);
        dkr[4 * d4] = fmaf(ds, qv.x, dkr[4 * d4]);
        dkr[4 * d4 + 1] = fmaf(ds, qv.y, dkr[4 * d4 + 1]);
        dkr[4 * d4 + 2] = fmaf(ds, qv.z, dkr[4 * d4 + 2]);
        dkr[4 * d4 + 3] = fmaf(ds, qv.w, dkr[4 * d4 + 3]);
      }
    }
  }
  if (c >= M) return;
  if (Hkv == 1) {
    // per-head partial sums: work[0 = dk | 1 = dv][b][h][c][:]
    const size_t plane = static_cast<size_t>(B) * H * M * D;
    float* wk = work + (static_cast<size_t>(bh) * M + c) * D;
    float* wv = wk + plane;
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      reinterpret_cast<float4*>(wk)[d4] =
          make_float4(dkr[4 * d4] * scale, dkr[4 * d4 + 1] * scale,
                      dkr[4 * d4 + 2] * scale, dkr[4 * d4 + 3] * scale);
      reinterpret_cast<float4*>(wv)[d4] = make_float4(
          dvr[4 * d4], dvr[4 * d4 + 1], dvr[4 * d4 + 2], dvr[4 * d4 + 3]);
    }
    return;
  }
  const size_t out = ((static_cast<size_t>(b) * M + c) * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    store1(dk + out + d, dkr[d] * scale);
    store1(dv + out + d, dvr[d]);
  }
}

// ---------------------------------------------------------------- pass 3
// Hkv = 1: dk[b][c][:] = sum over h of work[0][b][h][c][:] (dv likewise),
// the heads summed in order
template <typename T>
__global__ void head_sum_kernel(const float* __restrict__ work,
                                T* __restrict__ dk, T* __restrict__ dv,
                                int B, int H, int M) {
  const size_t per_b = static_cast<size_t>(M) * D;
  const size_t total = static_cast<size_t>(B) * per_b;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const size_t b = i / per_b;
  const size_t r = i - b * per_b;
  const size_t plane = total * H;
  const float* wk = work + b * H * per_b + r;
  float sk = 0.f;
  float sv = 0.f;
  for (int h = 0; h < H; ++h) {
    sk += wk[h * per_b];
    sv += wk[plane + h * per_b];
  }
  store1(dk + i, sk);
  store1(dv + i, sv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* slopes,
           const void* key_lens, const void* q_lens, const void* seed,
           const void* o, const void* lse, const void* dout, void* dq,
           void* dk, void* dv, void* dslopes, void* delta, void* work, int B,
           int N, int M, int H, int Hkv, int offset, int causal, float scale,
           int thresh, float inv_keep, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* sl = static_cast<const float*>(slopes);
  const int* kl = static_cast<const int*>(key_lens);
  const int* ql = static_cast<const int*>(q_lens);
  const int* sd = static_cast<const int*>(seed);
  flash_dq_kernel<T><<<dim3((N + BQ - 1) / BQ, H, B), BQ, 0, st>>>(
      qt, kt, vt, sl, kl, ql, sd, static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(dslopes),
      static_cast<float*>(delta), N, M, H, Hkv, offset, causal, scale, thresh,
      inv_keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_kernel<T><<<dim3((M + BC - 1) / BC, H, B), BC, 0, st>>>(
      qt, kt, vt, sl, kl, ql, sd, static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(work), B,
      N, M, H, Hkv, offset, causal, scale, thresh, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess || Hkv != 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * M * D;
  head_sum_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(work), static_cast<T*>(dk), static_cast<T*>(dv),
      B, H, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int isp_flash_bwd(const void* q, const void* k, const void* v,
                             const void* slopes, const void* key_lens,
                             const void* q_lens, const void* seed,
                             const void* o, const void* lse, const void* dout,
                             void* dq, void* dk, void* dv, void* dslopes,
                             void* delta, void* work, int B, int N, int M,
                             int H, int Hkv, int offset, int causal,
                             float scale, int thresh, float inv_keep,
                             int dtype, void* stream) {
  if (H > 65535 || B > 65535 || !(Hkv == 1 || Hkv == H) ||
      (Hkv == 1 && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, k, v, slopes, key_lens, q_lens, seed, o, lse, dout,
                         dq, dk, dv, dslopes, delta, work, B, N, M, H, Hkv,
                         offset, causal, scale, thresh, inv_keep, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, slopes, key_lens, q_lens, seed, o,
                                 lse, dout, dq, dk, dv, dslopes, delta, work, B,
                                 N, M, H, Hkv, offset, causal, scale, thresh,
                                 inv_keep, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
