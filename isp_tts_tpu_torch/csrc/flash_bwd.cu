// Per-head streaming attention backward with in-kernel learned-ALiBi bias
// and probability dropout.
//
// Replaces the TPU kernels isp_tts_tpu/ops/flash_attention.py:_dq_kernel
// and _dkv_kernel (wrapper _flash_bwd): the backward of flash_fwd.cu, with
// the same layouts (q, o, dO, dq (B, N, H, D); k, v, dk, dv
// (B, M, Hkv, D), Hkv = H or 1; with Hkv = 1 dk and dv sum over the
// heads). The keep bit is the forward's hash of ((b*HH + h)*N + n)*M + c
// plus the seed shift.
//
// What bounds it on an H100: it moves q, o, dO, dq and Hkv heads of K/V in
// and out (2*D bytes a row each in bf16), and does 10*D operations per
// (query, key) pair. At the decoder's bf16 training shape (B 32,
// N = M = 320, H 6, Hkv 6, D 64) the bytes, ~63 MB: 19 us at 3.35 TB/s,
// against at most 12.6 GFLOP, 12.7 us at the bf16 tensor-core peak. So the
// design is the tile core of attention_bwd.cuh on the tensor cores, at the
// tile width ATT_TILE_D >= D: the dq pass over blocks of (batch, head, 64
// queries), the dk/dv pass over blocks of 64 keys of one head (Hkv = H),
// or of the one K/V head walking every head's rows (Hkv = 1, no per-head
// partial sums), split over `splits` blocks where the blocks do not fill
// the card and summed in a fixed order.
//
// Plain C interface for ctypes; the launches go on the caller's stream and
// the function returns the first CUDA error. Built once per tile width
// (-DATT_TILE_D=16, 32, 64 or 128): it takes head dims D that are
// multiples of 8 up to that width.

#include "attention_bwd.cuh"

extern "C" int isp_flash_bwd(const void* q, const void* k, const void* v,
                             const void* slopes, const void* key_lens,
                             const void* q_lens, const void* seed,
                             const void* o, const void* lse, const void* dout,
                             void* dq, void* dk, void* dv, void* dslopes,
                             void* delta, void* work, int B, int N, int M,
                             int H, int Hkv, int D, int offset, int causal,
                             float scale, int thresh, float inv_keep,
                             int splits, int hash_heads,
                             unsigned int seed_shift, int dtype, void* stream) {
  const int heads = Hkv == 1 ? 1 : H;  // key-stationary blocks per split
  if (H > 65535 || B > 65535 || !(Hkv == 1 || Hkv == H) || splits < 1 || hash_heads < H ||
      static_cast<long long>(splits) * heads > 65535 || (splits > 1 && work == nullptr) ||
      D < 8 || D > ATT_DT || D % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdParams p{q, k, v, static_cast<const float*>(slopes),
                    static_cast<const int*>(key_lens), static_cast<const int*>(q_lens),
                    static_cast<const int*>(seed), o, static_cast<const float*>(lse), dout,
                    dq, dk, dv, static_cast<float*>(dslopes), static_cast<float*>(delta),
                    static_cast<float*>(work), B, N, M, H, Hkv, offset, causal, scale, thresh,
                    inv_keep, splits, hash_heads, seed_shift, D};
  const dim3 grid1((N + ATT_ROWS - 1) / ATT_ROWS, H, B);
  const dim3 grid2((M + ATT_ROWS - 1) / ATT_ROWS, splits * heads, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_attention_bwd<float, ATT_DT, HeadRows, HeadKeys>(grid1, grid2, p, st);
  } else if (dtype == 1) {
    err = launch_attention_bwd<__nv_bfloat16, ATT_DT, HeadRows, HeadKeys>(grid1, grid2, p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of the dtype's larger pass, in bytes.
extern "C" int isp_flash_bwd_smem_bytes(int dtype) { return bwd_smem_bytes_of<ATT_DT>(dtype); }

// The tile width this library was built for: the largest head dim it takes.
extern "C" int isp_flash_bwd_tile_d() { return ATT_DT; }
