// Folded multi-query attention backward with in-kernel learned-ALiBi bias
// and probability dropout.
//
// Replaces the TPU kernels isp_tts_tpu/ops/flash_attention.py:
// _mqa_dfused_kernel (wrapper _mqa_bwd_fused, used while the key axis fits
// resident, M <= 2048) and _mqa_dq_kernel + _mqa_dkv_kernel (wrapper
// _mqa_bwd, key-streamed above that). Those are one function under two TPU
// VMEM policies; on Hopper one design serves both, since each pass streams
// its other axis through shared memory and has no resident limit.
//
// Rows are folded as in the forward (mqa_fwd.cu): row r = n * H + h of the
// (B, N*H, D) view of q and dO reads the one shared (B, M, D) key/value
// head; dk and dv sum over the H heads. The keep bit is the forward's hash
// of the folded index ((b*N + n)*HH + h)*M + c plus the seed shift.
//
// What bounds it on an H100: it moves q, o, dO and dq (2*D bytes a row
// each in bf16) and one K/V head in and out, and does 10*D operations per
// (row, key) pair. At the decoder's bf16 training shape (B 32, N = M = 320,
// H 6, D 64) the bytes, ~37 MB: 11 us at 3.35 TB/s, against at most 12.6
// GFLOP, 12.7 us at the bf16 tensor-core peak. So the design is the tile
// core of attention_bwd.cuh on the tensor cores, at the tile width
// ATT_TILE_D >= D: the dq pass over blocks of 64 folded rows (each K/V
// tile staged in shared memory serves every head of ~64/H queries), the
// dk/dv pass over blocks of 64 keys that walk every head's rows of their
// keys, split over `splits` blocks to fill the card and summed in a fixed
// order.
//
// Plain C interface for ctypes; the launches go on the caller's stream and
// the function returns the first CUDA error. Built once per tile width
// (-DATT_TILE_D=16, 32, 64 or 128): it takes head dims D that are
// multiples of 8 up to that width.

#include "attention_bwd.cuh"

extern "C" int isp_mqa_bwd(const void* q, const void* k, const void* v,
                           const void* slopes, const void* key_lens,
                           const void* q_lens, const void* seed, const void* o,
                           const void* lse, const void* dout, void* dq, void* dk,
                           void* dv, void* dslopes, void* delta, void* work,
                           int B, int N, int M, int H, int D, int offset, int causal,
                           float scale, int thresh, float inv_keep, int splits,
                           int hash_heads, unsigned int seed_shift, int dtype,
                           void* stream) {
  if (B > 65535 || H > ATT_ROWS || splits < 1 || splits > 65535 || hash_heads < H ||
      (splits > 1 && work == nullptr) || D < 8 || D > ATT_DT || D % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdParams p{q, k, v, static_cast<const float*>(slopes),
                    static_cast<const int*>(key_lens), static_cast<const int*>(q_lens),
                    static_cast<const int*>(seed), o, static_cast<const float*>(lse), dout,
                    dq, dk, dv, static_cast<float*>(dslopes), static_cast<float*>(delta),
                    static_cast<float*>(work), B, N, M, H, 1, offset, causal, scale, thresh,
                    inv_keep, splits, hash_heads, seed_shift, D};
  const dim3 grid1((N * H + ATT_ROWS - 1) / ATT_ROWS, B);
  const dim3 grid2((M + ATT_ROWS - 1) / ATT_ROWS, splits, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_attention_bwd<float, ATT_DT, FoldedRows, FoldedKeys>(grid1, grid2, p, st);
  } else if (dtype == 1) {
    err = launch_attention_bwd<__nv_bfloat16, ATT_DT, FoldedRows, FoldedKeys>(grid1, grid2, p,
                                                                             st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of the dtype's larger pass, in bytes.
extern "C" int isp_mqa_bwd_smem_bytes(int dtype) { return bwd_smem_bytes_of<ATT_DT>(dtype); }

// The tile width this library was built for: the largest head dim it takes.
extern "C" int isp_mqa_bwd_tile_d() { return ATT_DT; }
