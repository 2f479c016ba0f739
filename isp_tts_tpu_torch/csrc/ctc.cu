// Banded ordered-label CTC: -log Z of the label sequence [1..text_len] over
// a (mel x (text+1)) log-probability map, and its gradient.
//
// Replaces the TPU kernels isp_tts_tpu/ops/ctc_pallas.py:_fwd_kernel
// (wrapper _run_fwd) and _bwd_kernel (wrapper _ctc_bwd). With distinct,
// ordered labels the CTC lattice collapses to two state vectors of width
// W = T + 1 (blank after j labels; emitting label j+1), streamed over frames:
//   c_j       = lse(blank_j, label_{j-1})
//   blank_j  <- c_j + lp[t, 0]
//   label_j  <- lse(label_j, c_j) + lp[t, j+1]      (lp[t, W] = NEG)
// with NEG = -1e30, lse(a, b) = max + log1p(exp(-|a - b|)), frames at or
// past mel_len frozen, and log Z = lse(blank_L, label_{L-1}) for
// L = clip(text_len, 1, T). The forward stores every frame's alphas. The
// backward runs the beta recursion from the accept states and writes
//   dlp[t, 0]   = -g * sum_j exp(min(ab_t[j] + bb_t[j] - log Z, 0))
//   dlp[t, j+1] = -g * exp(min(al_t[j] + bl_t[j] - log Z, 0))
// (the clip at 0 keeps an infeasible sample, log Z ~ NEG, from giving
// inf * 0), and zero past mel_len. The zero_infinity gate is the loss's.
//
// Precision: alpha and beta grow to ~mel_len * |log p| (thousands at
// mel 1024), and in f32 each step's rounding at that magnitude (~1e-4)
// would reach the gradient through exp(alpha + beta - log Z) as a relative
// error of 1e-3. So the state vectors, the stored alphas and log Z are
// f64; the transcendental part of each lse, log1p(exp(-|a - b|)) <= log 2,
// and the occupancy exp are f32 on arguments of small magnitude.
//
// What bounds it on an H100: a chain of mel_len dependent frames, each a
// few transcendental ops over W <= 1024 states; bytes are the map read
// twice, the alphas written once and read once, the gradient written once.
// The design: one block per batch element, one thread per state column,
// both state vectors double-buffered in shared memory, one __syncthreads
// per frame in the forward; the backward adds a block reduction per frame
// for the blank occupancy.
//
// Plain C interface for ctypes; each launch goes on the caller's stream and
// its function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double NEG = -1e30;

__device__ __forceinline__ double lse(double a, double b) {
  const float tail = log1pf(expf(-static_cast<float>(fabs(a - b))));
  return fmax(a, b) + static_cast<double>(tail);
}

__global__ void ctc_fwd_kernel(const float* __restrict__ lp,
                               const int* __restrict__ text_lens,
                               const int* __restrict__ mel_lens,
                               double* __restrict__ ab, double* __restrict__ al,
                               double* __restrict__ logz,
                               float* __restrict__ neg_logp, int M, int W) {
  extern __shared__ double sm[];  // blank[2][W], label[2][W]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool col = j < W;
  const int ml = min(mel_lens[b], M);
  double* bc = sm;
  double* bn = sm + W;
  double* lc = sm + 2 * W;
  double* ln = sm + 3 * W;
  if (col) {
    bc[j] = j == 0 ? 0.0 : NEG;
    lc[j] = NEG;
  }
  __syncthreads();
  for (int t = 0; t < ml; ++t) {
    const size_t at = (static_cast<size_t>(b) * M + t) * W;
    if (col) {
      const double c = lse(bc[j], j > 0 ? lc[j - 1] : NEG);
      const double nb = c + lp[at];
      const double nl = lse(lc[j], c) + (j + 1 < W ? lp[at + j + 1] : NEG);
      bn[j] = nb;
      ln[j] = nl;
      ab[at + j] = nb;
      al[at + j] = nl;
    }
    __syncthreads();
    double* t1 = bc;
    bc = bn;
    bn = t1;
    double* t2 = lc;
    lc = ln;
    ln = t2;
  }
  if (j == 0) {
    const int L = min(max(text_lens[b], 1), W - 1);
    const double z = lse(bc[L], lc[L - 1]);
    logz[b] = z;
    neg_logp[b] = static_cast<float>(-z);
  }
}

__global__ void ctc_bwd_kernel(const float* __restrict__ lp,
                               const double* __restrict__ ab,
                               const double* __restrict__ al,
                               const double* __restrict__ logz,
                               const float* __restrict__ g,
                               const int* __restrict__ text_lens,
                               const int* __restrict__ mel_lens,
                               float* __restrict__ dlp, int M, int W) {
  extern __shared__ double sm[];  // beta_blank[W], beta_label[W], new blank[W]
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const bool col = j < W;
  const int ml = min(mel_lens[b], M);
  const int L = min(max(text_lens[b], 1), W - 1);
  const double z = logz[b];
  const float gb = g[b];
  double* bb = sm;
  double* bl = sm + W;
  double* nbb = sm + 2 * W;
  if (col) {
    bb[j] = j == L ? 0.0 : NEG;
    bl[j] = j == L - 1 ? 0.0 : NEG;
    for (int t = ml; t < M; ++t) dlp[(static_cast<size_t>(b) * M + t) * W + j] = 0.f;
  }
  __syncthreads();
  for (int t = ml - 1; t >= 0; --t) {
    const size_t at = (static_cast<size_t>(b) * M + t) * W;
    float occ_b = 0.f;
    double u = NEG;
    double w = NEG;
    if (col) {
      const double beta_b = bb[j];
      const double beta_l = bl[j];
      occ_b = expf(static_cast<float>(fmin(ab[at + j] + beta_b - z, 0.0)));
      const float occ_l = expf(static_cast<float>(fmin(al[at + j] + beta_l - z, 0.0)));
      if (j + 1 < W) dlp[at + j + 1] = -gb * occ_l;
      u = beta_b + lp[at];
      w = beta_l + (j + 1 < W ? lp[at + j + 1] : NEG);
    }
    // blank occupancy: the sum over every blank state goes to column 0
    for (int o = 16; o > 0; o >>= 1) occ_b += __shfl_down_sync(0xffffffffu, occ_b, o);
    if ((j & 31) == 0) red[j >> 5] = occ_b;
    __syncthreads();
    if (j == 0) {
      float s = 0.f;
      for (int i = 0; i < (blockDim.x >> 5); ++i) s += red[i];
      dlp[at] = -gb * s;
    }
    const double nb = lse(u, w);
    if (col) nbb[j] = nb;
    __syncthreads();
    if (col) {
      bb[j] = nb;
      bl[j] = lse(w, j + 1 < W ? nbb[j + 1] : NEG);
    }
  }
}

int block_threads(int W) { return ((W + 31) / 32) * 32; }

}  // namespace

extern "C" int isp_ctc_fwd(const void* lp, const void* text_lens,
                           const void* mel_lens, void* ab, void* al, void* logz,
                           void* neg_logp, int B, int M, int W, void* stream) {
  if (W < 2 || W > 1024) return static_cast<int>(cudaErrorInvalidValue);
  ctc_fwd_kernel<<<B, block_threads(W), 4 * W * sizeof(double),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const int*>(text_lens),
      static_cast<const int*>(mel_lens), static_cast<double*>(ab),
      static_cast<double*>(al), static_cast<double*>(logz),
      static_cast<float*>(neg_logp), M, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int isp_ctc_bwd(const void* lp, const void* ab, const void* al,
                           const void* logz, const void* g, const void* text_lens,
                           const void* mel_lens, void* dlp, int B, int M, int W,
                           void* stream) {
  if (W < 2 || W > 1024) return static_cast<int>(cudaErrorInvalidValue);
  ctc_bwd_kernel<<<B, block_threads(W), 3 * W * sizeof(double),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const double*>(ab),
      static_cast<const double*>(al), static_cast<const double*>(logz),
      static_cast<const float*>(g), static_cast<const int*>(text_lens),
      static_cast<const int*>(mel_lens), static_cast<float*>(dlp), M, W);
  return static_cast<int>(cudaGetLastError());
}
