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
// then j = text_len - 1 at row mel_len - 1, stepping
// j = max(j - diag[i, max(j, 0)], 0) for 0 < i < mel_len; rows i < mel_len
// are one-hot at j (none for j = -1), the rest zero. Each step is one f32
// max and one f32 add, as in JAX, so the result is bit-identical to the
// port's plain version.
//
// What bounds it on an H100: a chain of mel_len dependent rows, then a walk
// back through them, each run by one warp's in-order instruction stream;
// the bytes (the map read once, the one-hot written once) take ~1 us at the
// training shape. So the design (dp_common.cuh) keeps a row's instructions
// few: one warp per sequence up to T = 256 (C <= 8 columns a lane, built
// for one warp so the registers hold every address), the DP row in
// registers, lp[i-1, j-1] by one shuffle, so a row's step on the chain is a
// shuffle, a max and an add. The map rows are staged into a ring of D rows
// by cp.async ahead of the wavefront, through running pointers. Each row's
// choice bits are one __ballot_sync word per 32 columns, kept in shared
// memory (M x ceil(T/32) words: 2.5 KB at the training shape) or, past
// SMEM_BITS, in a global scratch. The walk goes back in windows of 32 rows:
// the path moves at most one column a row, so a window's rows need only
// the words of two 32-column blocks, which the warp loads at once (one row
// a lane) and hands over by shuffles that do not depend on the walk; the
// walk itself is register arithmetic. Each window's one-hot rows are then
// written by every warp, its own columns, coalesced. Launch: one block of
// nw warps per sequence, grid B, as in K4; past 256 columns the row is
// split over up to 24 warps (T 6144), with the edge exchange of
// dp_common.cuh.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the function returns cudaGetLastError().

#include "dp_common.cuh"

namespace {

constexpr float NEG_INF = -1e9f;
// column blocks a lane at most: past 32 * C_MAX columns the row is split
constexpr int C_MAX = 8;
// warps a row takes at most (T 6144)
constexpr int WARPS_MAX = 24;
// the choice bits stay in shared memory while the block's total fits here
constexpr size_t SMEM_BITS = 100 * 1024;

// rows in a lane's staging ring: 16, but 8 where 24 warps share the
// shared memory
__host__ __device__ constexpr int ring_rows(int warps) { return warps == 1 ? 16 : 8; }

// Row s of the map into slot s % D of the lane's ring (block k: a[s, j0 +
// 32 k]), one commit group a row, rows in order.
template <int C, int D>
struct RowStage {
  float* ring;
  const float* src;  // a[s, j0]
  int s, ml, T, lane, j0;

  __device__ __forceinline__ void fetch() {
    float* slot = ring + (s & (D - 1)) * C * 32;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      cp_async4(slot + k * 32 + lane, src + 32 * k, s < ml && j0 + 32 * k < T);
    }
    cp_async_commit();
    ++s;
    src += T;
  }
};

// Shared memory: each warp's ring of D rows x C x 32 floats, the edge slots
// [2][nw], the walk's windows [2][32], then (bits_in_smem) the choice bits
// [M][nw * C] words. WARPS: the most warps the instantiation is built for.
template <int C, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) mas_kernel(
    const float* __restrict__ attn, const int* __restrict__ text_lens,
    const int* __restrict__ mel_lens, uint32_t* __restrict__ bits_global,
    float* __restrict__ out, int M, int T, int bits_in_smem) {
  constexpr int D = ring_rows(WARPS);
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = WARPS == 1 ? 1 : blockDim.x >> 5;
  const int w = WARPS == 1 ? 0 : threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int tl = max(min(text_lens[b], T), 0);
  const int ml = max(min(mel_lens[b], M), 0);
  const int NB = nw * C;  // choice-bit words a row
  const int j0 = 32 * w * C + lane;  // column of block 0
  float* edges = reinterpret_cast<float*>(smem) + nw * D * C * 32;
  int* windows = reinterpret_cast<int*>(edges + 2 * nw);
  uint32_t* bits = bits_in_smem ? reinterpret_cast<uint32_t*>(windows + 64)
                                : bits_global + static_cast<size_t>(b) * M * NB;
  const float* a = attn + static_cast<size_t>(b) * M * T;
  float* ob = out + static_cast<size_t>(b) * M * T;

  // rows at or past mel_len are zero
  for (int i = ml; i < M; ++i) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (j0 + 32 * k < T) ob[static_cast<size_t>(i) * T + j0 + 32 * k] = 0.f;  // one-hot store
    }
  }

  float lp[C];
#pragma unroll
  for (int k = 0; k < C; ++k) lp[k] = NEG_INF;
  if (j0 == 0 && tl > 0 && ml > 0) lp[0] = a[0];
  RowStage<C, D> stage{reinterpret_cast<float*>(smem) + w * D * C * 32, a + T + j0, 1, ml, T,
                       lane, j0};
  for (int s = 1; s < D; ++s) stage.fetch();

  uint32_t* bits_row = bits + NB + w * C + lane;  // row 1's word of block lane
  for (int i = 1; i < ml; ++i) {
    float edge = NEG_INF;  // lp of the column left of this warp's first
    if (nw > 1) {
      if (lane == 31) edges[(i & 1) * nw + w] = lp[C - 1];
      __syncthreads();
      if (w > 0) edge = edges[(i & 1) * nw + w - 1];
    }
    cp_async_wait<D - 2>();  // row i has landed
    stage.fetch();
    const float* slot = stage.ring + (i & (D - 1)) * C * 32;
    float sh[C];
#pragma unroll
    for (int k = 0; k < C; ++k) sh[k] = from_left(lp[k], lane);
    if (lane == 0) {
#pragma unroll
      for (int k = C - 1; k > 0; --k) sh[k] = sh[k - 1];
      sh[0] = edge;
    }
    uint32_t mine = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float x = j0 + 32 * k < tl ? slot[k * 32 + lane] : NEG_INF;  // map read
      const uint32_t word = __ballot_sync(FULL_MASK, sh[k] >= lp[k]);
      if (lane == k) mine = word;
      lp[k] = x + fmaxf(sh[k], lp[k]);
    }
    if (lane < C) *bits_row = mine;  // choice-bit store
    bits_row += NB;
  }
  cp_async_wait<0>();
  __syncthreads();

  // The walk back, 32 rows a window: warp 0 follows the choice bits and puts
  // each row's column in the window; then every warp writes the window's
  // one-hot rows, its own columns. With text_len 0 the last row is empty and
  // the rest take column 0, as in the plain version.
  int col = max(tl - 1, 0);
  int n = 0;
  for (int i0 = ml - 1; i0 >= 0; i0 -= 32, ++n) {
    int* win = windows + (n & 1) * 32;
    if (w == 0) {
      const int hb = col >> 5;
      const int row = i0 - lane;
      uint32_t hi = 0, lo = 0;
      if (row > 0) {
        hi = bits[static_cast<size_t>(row) * NB + hb];
        if (hb > 0) lo = bits[static_cast<size_t>(row) * NB + hb - 1];
      }
      const int base = 32 * hb - 32;  // bit 0 of lo; bit 0 of hi is base + 32
      int mine = -1;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const uint32_t h = __shfl_sync(FULL_MASK, hi, r);
        const uint32_t l = __shfl_sync(FULL_MASK, lo, r);
        if (lane == r) mine = col;
        if (i0 - r > 0) {
          const int off = col - base;  // in [1, 63] within the window
          const uint32_t bit = ((off >= 32 ? h : l) >> (off & 31)) & 1u;
          col = max(col - static_cast<int>(bit), 0);
        }
      }
      if (tl == 0 && n == 0 && lane == 0) mine = -1;
      win[lane] = mine;
    }
    __syncthreads();
    const int rows = min(32, i0 + 1);
    float* orow = ob + static_cast<size_t>(i0) * T + j0;
    for (int r = 0; r < rows; ++r, orow -= T) {
      const int pj = win[r] - j0;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (j0 + 32 * k < T) orow[32 * k] = pj == 32 * k ? 1.f : 0.f;  // one-hot store
      }
    }
  }
}

struct Plan {
  RowSplit split;
  size_t smem;         // dynamic shared memory of the launch
  size_t bits_global;  // bytes of global scratch a batch element (0: bits in smem)
};

Plan plan(int M, int T) {
  const RowSplit s = row_split(T, C_MAX);
  const size_t base = static_cast<size_t>(s.warps) * ring_rows(s.warps) * s.blocks * 32 * 4
                      + 2 * s.warps * sizeof(float) + 64 * sizeof(int);
  const size_t bits = static_cast<size_t>(M) * s.warps * s.blocks * 4;
  if (base + bits <= SMEM_BITS) return {s, base + bits, 0};
  return {s, base, bits};
}

template <int C, int WARPS>
cudaError_t launch(const void* attn, const void* text_lens, const void* mel_lens, void* bits,
                   void* out, int B, int M, int T, const Plan& p, cudaStream_t stream) {
  constexpr auto kernel = mas_kernel<C, WARPS>;
  cudaError_t err = allow_smem<kernel>(p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, 32 * p.split.warps, p.smem, stream>>>(
      static_cast<const float*>(attn), static_cast<const int*>(text_lens),
      static_cast<const int*>(mel_lens), static_cast<uint32_t*>(bits), static_cast<float*>(out),
      M, T, p.bits_global == 0 ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// Bytes of global scratch for the choice bits a batch element needs at
// (M, T): 0 where they fit in shared memory.
extern "C" long long isp_mas_scratch_bytes(int M, int T) {
  return static_cast<long long>(plan(M, T).bits_global);
}

// bits: isp_mas_scratch_bytes(M, T) * B bytes of scratch (unused when 0).
extern "C" int isp_mas(const void* attn, const void* text_lens, const void* mel_lens,
                       void* bits, void* out, int B, int M, int T, void* stream) {
  if (T < 1 || T > 32 * WARPS_MAX * C_MAX || M < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(M, T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* in[3] = {attn, text_lens, mel_lens};
  cudaError_t err = cudaErrorInvalidValue;
  if (p.split.warps == 1) {  // C = 1..8
    switch (p.split.blocks) {
      case 1: err = launch<1, 1>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 2: err = launch<2, 1>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 3: err = launch<3, 1>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 4: err = launch<4, 1>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 5: err = launch<5, 1>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 6: err = launch<6, 1>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 7: err = launch<7, 1>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 8: err = launch<8, 1>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
    }
  } else {  // past 256 columns: C = 5..8
    switch (p.split.blocks) {
      case 5: err = launch<5, WARPS_MAX>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 6: err = launch<6, WARPS_MAX>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 7: err = launch<7, WARPS_MAX>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
      case 8: err = launch<8, WARPS_MAX>(in[0], in[1], in[2], bits, out, B, M, T, p, st); break;
    }
  }
  return static_cast<int>(err);
}
