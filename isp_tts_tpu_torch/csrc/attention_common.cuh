// Device helpers shared by the attention kernels (mqa_fwd.cu, flash_fwd.cu,
// mqa_bwd.cu, flash_bwd.cu, through the tile cores attention_fwd.cuh and
// attention_bwd.cuh): the tile sizes, the dropout keep hash, widening loads
// between the input type and f32, and the row geometries that are the only
// difference between the folded-MQA kernels (K1, K2) and the per-head ones
// (K5a, K5b).
//
// Head dims: the tile cores are templates on the tile width DT (16, 32, 64
// or 128 columns of every Q, K, V and dO tile); the kernel parameters carry
// the head dim D (a multiple of 8, D <= DT), the row stride of every tensor
// in device memory. Columns D .. DT - 1 of a tile are zero in shared memory
// and in the A fragments: they add nothing to a product over the head dim,
// and the output columns they give (of o, dq, dk, dv) are never stored.
// Each kernel has two instantiations a width: kFullD (D == DT, the head dim
// a compile-time constant, so the column checks and strides fold away as
// they did when every head dim was 64) and the general one (D < DT). Each
// source is built once per DT, with -DATT_TILE_D=DT (ops/cuda_build.py),
// and the wrapper picks the least DT >= D.
//
// Every .cu file that includes this header is its own translation unit, so
// the helpers sit in an anonymous namespace there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef ATT_TILE_D
#error "build each attention source with -DATT_TILE_D=16, 32, 64 or 128 (ops/cuda_build.py)"
#endif
// the tile width this translation unit instantiates its kernels at
constexpr int ATT_DT = ATT_TILE_D;
static_assert(ATT_DT == 16 || ATT_DT == 32 || ATT_DT == 64 || ATT_DT == 128,
              "ATT_TILE_D must be 16, 32, 64 or 128");
constexpr int ATT_ROWS = 64;      // rows (queries, or keys) per block
constexpr int ATT_KEYS = 64;      // rows per shared-memory tile
constexpr int ATT_THREADS = 128;  // 4 warps of 16 rows
constexpr float ATT_NEG_INF = -1e30f;

// The JAX package's _keep_hash (isp_tts_tpu/ops/flash_attention.py): keep
// iff the top byte of the hash of (idx + seed) is below thresh. All in
// uint32 arithmetic, so an index past 2^32 wraps as the int32 index does
// there. The hash is keep_mix((idx + seed) * KEEP_MUL): the first product
// is linear in idx, so a loop over consecutive keys can step it by KEEP_MUL.
constexpr uint32_t KEEP_MUL = 2654435761u;

__device__ __forceinline__ uint32_t keep_mix(uint32_t u) {
  u ^= u >> 17;
  return u * 0x45D9F3Bu;
}

__device__ __forceinline__ bool keep_bit(uint32_t idx, uint32_t seed,
                                         uint32_t thresh) {
  return (keep_mix((idx + seed) * KEEP_MUL) >> 24) < thresh;
}

// Eight consecutive elements as f32 (16- or 32-byte aligned source).
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

// ------------------------------------------------------- row geometries
// The ALiBi bias of key c for query n is (c <= n + offset ? lo[h] :
// hi[h]) * -|c - n - offset|; the dropout keep bit hashes an index that is
// linear in c. Both families lay q, o, dO and dq out as (B, N, H, D); K1
// and K2 fold row r = n*H + h of the (B, N*H, D) view onto the one K/V
// head, K5a and K5b give each head its own block of rows.
//
// The dropout index is over the global batch and heads: a data rank's
// first batch row and a model rank's first head shift every index of the
// call by one amount, which the wrapper folds into the seed
// (p.seed_shift); the index's head stride is the global head count
// (p.hash_heads, H on one rank), so a rank's heads hash as one rank's do.
//
// Row-stationary blocks (the forwards, the backward's dq pass): Rows is
// built from the parameters and blockIdx and gives the block's row count
// and, for tile row i, its query n, head h, q/o element offset, lse index
// and dropout hash base, the block's K/V base offset and key stride, how
// far apart the rows of one head are (head_stride), and the blocks an SM
// the forward's bf16 launch bound asks for.

// Tile row i of block (x, b) is folded row r = x*64 + i: query r / H, head
// r % H, on the batch's one K/V head.
struct FoldedRows {
  // 3 bf16 blocks an SM: 4 (at 128 registers, with spills) measured slower
  // at the decoder's training shape (PERF.md §6)
  static constexpr int kBf16Blocks = 3;
  int b, r0, R, N, M, H, HH, D;

  template <typename P>
  __device__ FoldedRows(const P& p, int d)
      : b(blockIdx.y), r0(blockIdx.x * ATT_ROWS), R(p.N * p.H), N(p.N), M(p.M), H(p.H),
        HH(p.hash_heads), D(d) {}
  __device__ int count() const { return min(ATT_ROWS, R - r0); }
  __device__ int query(int i) const { return (r0 + i) / H; }
  __device__ int head(int i) const { return (r0 + i) % H; }
  __device__ int head_stride() const { return H; }
  // the block's slot among the backward's slope partials: b * blocks + x
  __device__ int part() const { return b * gridDim.x + blockIdx.x; }
  __device__ size_t q_offset(int i) const {
    return (static_cast<size_t>(b) * R + r0 + i) * D;
  }
  __device__ size_t lse_index(int i) const { return static_cast<size_t>(b) * R + r0 + i; }
  // ((b*N + n)*HH + h)*M, wrapping in uint32 as the TPU kernel's int32
  // index does: (b*R + r)*M when HH = H
  __device__ uint32_t hash_base(int i) const {
    return ((static_cast<uint32_t>(b) * static_cast<uint32_t>(N) +
             static_cast<uint32_t>(query(i))) * static_cast<uint32_t>(HH) +
            static_cast<uint32_t>(head(i))) * static_cast<uint32_t>(M);
  }
  __device__ size_t kv_offset() const { return static_cast<size_t>(b) * M * D; }
  __device__ size_t kv_stride() const { return D; }
};

// Tile row i of block (x, h, b) is query n0 + i of head h, whose K/V head
// is h (Hkv = H) or 0 (Hkv = 1), keys Hkv*D elements apart.
struct HeadRows {
  // 4 bf16 blocks an SM (128 registers, with spills): faster than 3 at the
  // decoder's training shape, where each block reads its own head's K/V
  // (PERF.md §6)
  static constexpr int kBf16Blocks = 4;
  int b, h, n0, N, H, M, Hkv, HH, D;

  template <typename P>
  __device__ HeadRows(const P& p, int d)
      : b(blockIdx.z), h(blockIdx.y), n0(blockIdx.x * ATT_ROWS), N(p.N), H(p.H), M(p.M),
        Hkv(p.Hkv), HH(p.hash_heads), D(d) {}
  __device__ int count() const { return min(ATT_ROWS, N - n0); }
  __device__ int query(int i) const { return n0 + i; }
  __device__ int head(int) const { return h; }
  __device__ int head_stride() const { return 1; }
  // the block's slot among the backward's slope partials, (b, x): the
  // heads' blocks of one slot write their own heads
  __device__ int part() const { return b * gridDim.x + blockIdx.x; }
  __device__ size_t q_offset(int i) const {
    return ((static_cast<size_t>(b) * N + n0 + i) * H + h) * D;
  }
  __device__ size_t lse_index(int i) const {
    return (static_cast<size_t>(b) * H + h) * N + n0 + i;
  }
  // ((b*HH + h)*N + n)*M, wrapping in uint32 as the TPU kernel's int32 does
  __device__ uint32_t hash_base(int i) const {
    return ((static_cast<uint32_t>(b) * static_cast<uint32_t>(HH) +
             static_cast<uint32_t>(h)) * static_cast<uint32_t>(N) +
            static_cast<uint32_t>(n0 + i)) * static_cast<uint32_t>(M);
  }
  __device__ size_t kv_offset() const {
    return (static_cast<size_t>(b) * M * Hkv + (Hkv == 1 ? 0 : h)) * D;
  }
  __device__ size_t kv_stride() const { return static_cast<size_t>(Hkv) * D; }
};

// Key-stationary blocks (the backward's dk/dv pass): block (x, y, b) holds
// keys x*64 .. x*64 + 63 and walks row tiles of 64 consecutive queries of
// one head, over the heads [head_lo, head_hi) that read its keys; y counts
// the row-range splits (and, per head, the heads). Keys gives the block's
// split, K/V (and dK/dV) base offset and key stride, and for query n of
// head h the q/dO element offset, lse index and dropout hash base, with the
// strides of those between consecutive queries.

// K2: every head reads the one K/V head.
struct FoldedKeys {
  int b, N, M, H, HH, D;

  template <typename P>
  __device__ FoldedKeys(const P& p, int d)
      : b(blockIdx.z), N(p.N), M(p.M), H(p.H), HH(p.hash_heads), D(d) {}
  __device__ int split() const { return blockIdx.y; }
  __device__ int head_lo() const { return 0; }
  __device__ int head_hi() const { return H; }
  __device__ size_t kv_offset() const { return static_cast<size_t>(b) * M * D; }
  __device__ size_t kv_stride() const { return D; }
  __device__ size_t q_offset(int n, int h) const {
    return ((static_cast<size_t>(b) * N + n) * H + h) * D;
  }
  __device__ size_t q_stride() const { return static_cast<size_t>(H) * D; }
  __device__ size_t lse_index(int n, int h) const {
    return (static_cast<size_t>(b) * N + n) * H + h;
  }
  __device__ size_t lse_stride() const { return H; }
  __device__ uint32_t hash_base(int n, int h) const {
    return ((static_cast<uint32_t>(b) * static_cast<uint32_t>(N) + static_cast<uint32_t>(n)) *
                static_cast<uint32_t>(HH) + static_cast<uint32_t>(h)) * static_cast<uint32_t>(M);
  }
  __device__ uint32_t hash_stride() const {
    return static_cast<uint32_t>(HH) * static_cast<uint32_t>(M);
  }
};

// K5b: with Hkv = H the block's head (y % H) alone; with Hkv = 1 all heads.
// The block's split and head are read from blockIdx at each use, so the
// policy holds no more registers than FoldedKeys.
struct HeadKeys {
  int b, N, M, H, Hkv, HH, D;

  template <typename P>
  __device__ HeadKeys(const P& p, int d)
      : b(blockIdx.z), N(p.N), M(p.M), H(p.H), Hkv(p.Hkv), HH(p.hash_heads), D(d) {}
  __device__ int split() const { return Hkv == 1 ? blockIdx.y : blockIdx.y / H; }
  __device__ int head_lo() const { return Hkv == 1 ? 0 : blockIdx.y % H; }
  __device__ int head_hi() const { return Hkv == 1 ? H : head_lo() + 1; }
  __device__ size_t kv_offset() const {
    return (static_cast<size_t>(b) * M * Hkv + head_lo()) * D;
  }
  __device__ size_t kv_stride() const { return static_cast<size_t>(Hkv) * D; }
  __device__ size_t q_offset(int n, int h) const {
    return ((static_cast<size_t>(b) * N + n) * H + h) * D;
  }
  __device__ size_t q_stride() const { return static_cast<size_t>(H) * D; }
  __device__ size_t lse_index(int n, int h) const {
    return (static_cast<size_t>(b) * H + h) * N + n;
  }
  __device__ size_t lse_stride() const { return 1; }
  __device__ uint32_t hash_base(int n, int h) const {
    return ((static_cast<uint32_t>(b) * static_cast<uint32_t>(HH) + static_cast<uint32_t>(h)) *
                static_cast<uint32_t>(N) + static_cast<uint32_t>(n)) * static_cast<uint32_t>(M);
  }
  __device__ uint32_t hash_stride() const { return static_cast<uint32_t>(M); }
};

}  // namespace
