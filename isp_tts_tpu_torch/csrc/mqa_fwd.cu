// Folded multi-query attention forward with in-kernel learned-ALiBi bias.
//
// Replaces the TPU kernel isp_tts_tpu/ops/flash_attention.py:_mqa_fwd_kernel
// (wrapper _mqa_fwd). Query rows are folded: row r = n * H + h of the
// (B, N*H, D) view of q attends the one shared (B, M, D) key/value head.
// The bias is recomputed from the per-head slopes, never read from memory:
//   dist = -|c - n - offset|,  bias = (c <= n + offset ? lo[h] : hi[h]) * dist
// Keys at or past key_lens[b] are masked, and with `causal` so are keys past
// n + offset. Rows with n >= q_lens[b], or that saw no valid key, write
// o = 0 and lse = +inf, as the TPU kernel does.
//
// Dropout (thresh < 256) acts on the post-softmax probabilities: the
// normaliser l sums the undropped p, the value product the dropped ones.
// The keep bit of (b, row r = n*H + h, key c) is the TPU kernel's
// _keep_hash of the folded index ((b*N + n)*HH + h)*M + c plus the seed
// and seed_shift, all in uint32 arithmetic: with HH = H and no shift the
// TPU kernel's (b*R + r)*M + c; a rank of a data or model split passes the
// global head count HH and its first row's and head's index as the shift,
// so its bits are the global call's. The index does not involve D. The
// backward (mqa_bwd.cu) regenerates them bit for bit.
//
// What bounds it on an H100: bytes. It moves q and o (2*D bytes a row each
// in bf16) and one K/V head shared by the H folded heads, and does 4*D
// operations per (row, key) pair. At the decoder's bf16 training shape
// (B 32, N = M = 320, H 6, D 64) that is ~19 MB, 5.6 us at 3.35 TB/s,
// against at most 5.0 GFLOP (every length full), 5.1 us at the bf16
// tensor-core peak; in f32 at the serving shape (B 4, N = M = 1024) the
// work, at most 6.4 GFLOP: 39 us at the 3xTF32 rate (three TF32 MMAs a
// product, 495 TFLOP/s over 3). Bytes and operations both scale with D.
// So the design keeps everything but q, k, v, o and lse out of device
// memory and the arithmetic on the tensor cores: the tile core of
// attention_fwd.cuh (mma.sync, cp.async double-buffered K/V tiles of the
// tile width ATT_TILE_D >= D) over blocks of 64 folded rows, so each K/V
// tile staged in shared memory serves every head of ~64/H queries. In bf16
// P.V takes P as p_hi + p_lo, two bf16 MMAs: the TPU kernel's rounding of
// P to bf16 moved the bf16 training step further past its gate (PERF.md §6).
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns the CUDA error of the launch. Built once per tile
// width (-DATT_TILE_D=16, 32, 64 or 128): it takes head dims D that are
// multiples of 8 up to that width.

#include "attention_fwd.cuh"

extern "C" int isp_mqa_fwd(const void* q, const void* k, const void* v,
                           const void* slopes, const void* key_lens,
                           const void* q_lens, const void* seed, void* o,
                           void* lse, int B, int N, int M, int H, int D, int offset,
                           int causal, float scale, int thresh, float inv_keep,
                           int hash_heads, unsigned int seed_shift, int dtype,
                           void* stream) {
  if (B > 65535 || hash_heads < H || D < 8 || D > ATT_DT || D % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdParams p{q, k, v, static_cast<const float*>(slopes),
                    static_cast<const int*>(key_lens), static_cast<const int*>(q_lens),
                    static_cast<const int*>(seed), o, static_cast<float*>(lse),
                    N, M, H, 1, offset, causal, scale, thresh, inv_keep, hash_heads,
                    seed_shift, D};
  const dim3 grid((N * H + ATT_ROWS - 1) / ATT_ROWS, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_attention_fwd<float, ATT_DT, FoldedRows>(grid, p, st);
  } else if (dtype == 1) {
    err = launch_attention_fwd<__nv_bfloat16, ATT_DT, FoldedRows>(grid, p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one block of the dtype's kernel, in bytes.
extern "C" int isp_mqa_fwd_smem_bytes(int dtype) { return fwd_smem_bytes_of<ATT_DT>(dtype); }

// Blocks of the dtype's kernel (full: the D == DT instantiation, else
// D < DT) that fit an SM of the current device; -1 on an error.
extern "C" int isp_mqa_fwd_blocks_per_sm(int dtype, int full) {
  return fwd_blocks_per_sm_of<ATT_DT, FoldedRows>(dtype, full);
}

// The tile width this library was built for: the largest head dim it takes.
extern "C" int isp_mqa_fwd_tile_d() { return ATT_DT; }
