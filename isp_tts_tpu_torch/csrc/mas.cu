// Monotonic alignment search (MAS): Viterbi DP over a (mel x text) log-
// attention map, backtrack, and the one-hot hard alignment.
//
// Replaces the TPU kernels isp_tts_tpu/ops/mas_pallas.py:_fwd_kernel (the
// DP, streamed over mel-row blocks) and _bwd_kernel (the reversed
// backtrack), wrapper monotonic_alignment_search_pallas. Semantics are the
// JAX package's f32 DP (isp_tts_tpu/ops/mas.py:monotonic_alignment_search):
//   a[i, j]  = log_attn[i, j] for j < text_len, else NEG_INF = -1e9
//   lp[0, j] = a[0, 0] if j == 0 else NEG_INF
//   lp[i, j] = a[i, j] + max(lp[i-1, j], lp[i-1, j-1])     (lp[., -1] = NEG_INF)
//   diag[i, j] = lp[i-1, j-1] >= lp[i-1, j]
// then j = text_len - 1 at row mel_len - 1, stepping j -= diag[i, j] for
// 0 < i < mel_len, clamped at 0; rows i < mel_len are one-hot at j, the
// rest zero. Each step is one f32 max and one f32 add, as in JAX, so the
// result is bit-identical to the port's plain version.
//
// What bounds it on an H100: the DP is a chain of mel_len dependent
// wavefronts, so no layout makes it wide; the data are bytes (the map read
// once, the one-hot written once). The design: one block per batch
// element, one thread per text column (looping past 1024); the DP row lives
// in shared memory, double-buffered, one __syncthreads per mel row; the
// choice bits go to global memory (one byte each) and thread 0 walks them
// back; then the whole block writes the one-hot rows coalesced.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e9f;

__global__ void mas_kernel(const float* __restrict__ attn,
                           const int* __restrict__ text_lens,
                           const int* __restrict__ mel_lens,
                           uint8_t* __restrict__ diag, int* __restrict__ path,
                           float* __restrict__ out, int M, int T) {
  extern __shared__ float lp[];  // 2 * T: current and next DP row
  const int b = blockIdx.x;
  const int tl = min(text_lens[b], T);
  const int ml = min(mel_lens[b], M);
  const float* a = attn + static_cast<size_t>(b) * M * T;
  uint8_t* dg = diag + static_cast<size_t>(b) * M * T;
  int* pb = path + static_cast<size_t>(b) * M;
  float* cur = lp;
  float* nxt = lp + T;

  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    cur[j] = (j == 0 && tl > 0) ? a[0] : NEG_INF;
  }
  __syncthreads();
  // columns >= text_len never feed a column below it: only j < tl is kept
  for (int i = 1; i < ml; ++i) {
    const float* ai = a + static_cast<size_t>(i) * T;
    for (int j = threadIdx.x; j < tl; j += blockDim.x) {
      const float prev = cur[j];
      const float sh = j > 0 ? cur[j - 1] : NEG_INF;
      dg[static_cast<size_t>(i) * T + j] = sh >= prev ? 1 : 0;
      nxt[j] = ai[j] + fmaxf(sh, prev);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  if (threadIdx.x == 0) {
    int j = tl - 1;
    for (int i = M - 1; i >= 0; --i) {
      if (i >= ml) {
        pb[i] = -1;
        continue;
      }
      pb[i] = j;
      if (i > 0 && j >= 0) {
        j = max(j - static_cast<int>(dg[static_cast<size_t>(i) * T + j]), 0);
      }
    }
  }
  __syncthreads();

  float* ob = out + static_cast<size_t>(b) * M * T;
  for (int i = 0; i < M; ++i) {
    const int pj = pb[i];
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
      ob[static_cast<size_t>(i) * T + j] = (j == pj) ? 1.f : 0.f;
    }
  }
}

}  // namespace

extern "C" int isp_mas(const void* attn, const void* text_lens,
                       const void* mel_lens, void* diag, void* path, void* out,
                       int B, int M, int T, void* stream) {
  const int warps = (T + 31) / 32;
  const int threads = warps < 32 ? 32 * warps : 1024;
  const size_t smem = 2 * static_cast<size_t>(T) * sizeof(float);
  mas_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attn), static_cast<const int*>(text_lens),
      static_cast<const int*>(mel_lens), static_cast<uint8_t*>(diag),
      static_cast<int*>(path), static_cast<float*>(out), M, T);
  return static_cast<int>(cudaGetLastError());
}
