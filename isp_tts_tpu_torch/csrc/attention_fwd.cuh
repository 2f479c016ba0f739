// The attention forward tile core shared by K1 (mqa_fwd.cu, folded rows on
// one key/value head) and K5a (flash_fwd.cu, one head per block): one
// templated kernel on Hopper's tensor cores through mma.sync, with the
// row geometry supplied by a small policy.
//
// Block: 4 warps (128 threads) over 64 query rows, 16 rows a warp. Key and
// value tiles of 64 keys arrive in shared memory by cp.async, double
// buffered, so that tile j+1 loads while tile j is in the MMAs; nothing is
// widened in shared memory (rows padded by one 16-byte chunk, so ldmatrix
// and the f32 value reads are free of bank conflicts). Each warp keeps its
// Q tile as A fragments in registers, loaded once, and its 16 x 64 logits
// and 16 x 64 output accumulator in registers: the logits' fragment element
// (row lane/4 or lane/4 + 8, column 2*(lane%4) + {0,1}) is where the bias,
// the masks, the dropout hash and the online softmax act, in f32 on the
// CUDA cores, and the same registers become the A fragment of P.V.
//
// Precision, per input type:
// - bf16: Q.K^T is mma.m16n8k16 on the bf16 inputs with f32 accumulation.
//   P.V takes P split as p_hi + p_lo, both bf16, in two MMAs (P kept to
//   ~2^-17), since _fwd_kernel (K5a's TPU kernel) runs P.V in f32.
//   _mqa_fwd_kernel (K1's) rounds P to bf16; in one bf16 training step
//   that rounding put the kernel path twice as far from the plain path as
//   the split does (PERF.md §6), so K1 splits as K5a does.
// - f32: both products are 3xTF32 mma.m16n8k8 (x = hi + lo, hi and lo
//   rounded to tf32; hi.hi + hi.lo + lo.hi), about f32 accuracy; plain TF32
//   would leave ~1e-3 in the logits. The m16n8k8 accumulator holds
//   columns (2t, 2t+1) of a thread's rows where its A fragment wants
//   (t, t+4), so P.V reads each 8-key slice in the order 0,2,4,6,1,3,5,7:
//   the thread's P registers go in unshuffled and its V rows are read as
//   keys 2t and 2t+1. A sum over keys does not see the order.
//
// The tensor cores' accumulator adds do not round to nearest: accumulated
// in one fragment over a long key loop, P.V drifts toward zero. So each
// tile's P.V is summed in fresh fragments and added to the output on the
// CUDA cores (rescale_add), which round to nearest.
//
// The softmax runs in base 2 (logits and slopes pre-multiplied by log2 e,
// one ex2.approx per probability); lse is returned in natural units. Per
// element the distance is one add off a per-row base (exact in f32), the
// dropout hash one add off a per-row product (it is linear in the key
// before its mix), and 1/(1 - rate) is applied once, to the output.
//
// Skipped work: key tiles past the block's last needed key (the key length,
// and under `causal` the diagonal of its last live row) are neither loaded
// nor computed; a warp skips the tiles past its own rows' needs; a block of
// dead rows loads nothing. A key tile wholly inside the key length and
// wholly on one side of every row's diagonal skips the per-element compares.
//
// Include only from the forward sources: every includer is its own
// translation unit, so the helpers sit in an anonymous namespace.

#pragma once

#include "attention_common.cuh"

namespace {

constexpr int FWD_D = 64;         // head dim (every recipe)
constexpr int FWD_ROWS = 64;      // query rows per block
constexpr int FWD_KEYS = 64;      // keys per shared-memory tile
constexpr int FWD_THREADS = 128;  // 4 warps of 16 rows
constexpr float FWD_NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The arguments both entry points take, as the kernel reads them.
struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* slopes;  // (2, H): lower, upper
  const int* key_lens;
  const int* q_lens;
  const int* seed;
  void* o;
  float* lse;
  int N, M, H, Hkv, offset, causal;
  float scale;
  int thresh;
  float inv_keep;
};

// Elements per padded shared-memory row of a K or V tile.
template <typename T>
__host__ __device__ constexpr int kv_row() {
  return FWD_D + 16 / static_cast<int>(sizeof(T));
}

// Dynamic shared memory of one block: two stages of K and of V.
template <typename T>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 4 * FWD_KEYS * kv_row<T>() * static_cast<int>(sizeof(T));
}

// The same for the entry points' dtype code (0 f32, 1 bf16), 0 for another.
inline int fwd_smem_bytes_of(int dtype) {
  return dtype == 0 ? fwd_smem_bytes<float>() : dtype == 1 ? fwd_smem_bytes<__nv_bfloat16>() : 0;
}

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-fill where !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16 bf16, row) . b (16 x 8 bf16, col), f32 accumulate. The
// MMAs touch registers only, so they are not volatile: the compiler may
// interleave independent accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8 tf32, row) . b (8 x 8 tf32, col), f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32 (the 3xTF32 split)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// 2^x, one MUFU instruction (relative error ~2^-22; 0 for x below -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) = hi + lo, two packed bf16 pairs: lo rounds what hi left
// (exactly, in f32), so the sum keeps x to ~2^-17 of its size.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// o[d0 + i] = o[d0 + i] * alpha + t[i] for the four accumulators of one
// half of the head dim, alpha[0] on row g (registers 0, 1), alpha[1] on
// row g + 8. The tensor cores' accumulator adds do not round to nearest,
// so a product accumulated in one fragment over a long key loop drifts;
// each tile's P.V is summed apart and added here on the CUDA cores.
__device__ __forceinline__ void rescale_add(float (&o)[8][4], int d0, const float (&t)[4][4],
                                            const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[d0 + i][r] = fmaf(o[d0 + i][r], alpha[r / 2], t[i][r]);
  }
}

// ------------------------------------------------- products, per input type
// Mma<T> holds a warp's Q fragments and runs its two products on one tile:
//   qk: s[j] (keys 8j..8j+7) = Q . K^T for the 64 keys of the tile;
//   pv: o[d] (dims 8d..8d+7) += P . V, P in s's accumulator layout.
// `ks`, `vs` point at the tile's first row; rows are kv_row<T>() apart. The
// loops put the reduction step outermost, so consecutive MMAs go to
// different accumulators.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int S = kv_row<T>();
  uint32_t qa[4][4];  // k-steps of 16 dims

  // rows g and g + 8 of the warp's tile (null: a row past the block)
  __device__ void load_q(const T* rg, const T* rg8, int t) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int d = 16 * kk + 2 * t;
      qa[kk][0] = rg ? *reinterpret_cast<const uint32_t*>(rg + d) : 0u;
      qa[kk][1] = rg8 ? *reinterpret_cast<const uint32_t*>(rg8 + d) : 0u;
      qa[kk][2] = rg ? *reinterpret_cast<const uint32_t*>(rg + d + 8) : 0u;
      qa[kk][3] = rg8 ? *reinterpret_cast<const uint32_t*>(rg8 + d + 8) : 0u;
    }
  }

  __device__ void qk(float (&s)[8][4], const T* ks, int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // dims 32h .. 32h + 31: k-steps 2h, 2h+1
      uint32_t b[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ldmatrix_x4(b[j], ks + (8 * j + lane % 8) * S + 32 * h + 8 * (lane / 8));
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(s[j], qa[2 * h + u], b[j][2 * u], b[j][2 * u + 1]);
      }
    }
  }

  // P goes in as two bf16 terms (split_bf16), the smaller first
  __device__ void pv(float (&o)[8][4], const float (&p)[8][4], const float (&alpha)[2],
                     const T* vs, int lane) const {
    uint32_t a[4][2][4];  // [keys 16j .. 16j + 15][hi, lo][A register]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_bf16(p[2 * j][0], p[2 * j][1], a[j][0][0], a[j][1][0]);
      split_bf16(p[2 * j][2], p[2 * j][3], a[j][0][1], a[j][1][1]);
      split_bf16(p[2 * j + 1][0], p[2 * j + 1][1], a[j][0][2], a[j][1][2]);
      split_bf16(p[2 * j + 1][2], p[2 * j + 1][3], a[j][0][3], a[j][1][3]);
    }
#pragma unroll
    for (int dh = 0; dh < 2; ++dh) {  // dims 32dh .. 32dh + 31
      float t[4][4] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[2][4];
#pragma unroll
        for (int d2 = 0; d2 < 2; ++d2) {
          ldmatrix_x4_trans(b[d2], vs + (16 * j + 8 * ((lane / 8) & 1) + lane % 8) * S +
                                       32 * dh + 16 * d2 + 8 * (lane / 16));
        }
#pragma unroll
        for (int term = 1; term >= 0; --term) {
#pragma unroll
          for (int d2 = 0; d2 < 2; ++d2) {
            mma_bf16(t[2 * d2], a[j][term], b[d2][0], b[d2][1]);
            mma_bf16(t[2 * d2 + 1], a[j][term], b[d2][2], b[d2][3]);
          }
        }
      }
      rescale_add(o, 4 * dh, t, alpha);
    }
  }

  __device__ static void store2(T* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

template <>
struct Mma<float> {
  using T = float;
  static constexpr int S = kv_row<T>();
  uint32_t qhi[8][4], qlo[8][4];  // k-steps of 8 dims

  __device__ void load_q(const T* rg, const T* rg8, int t) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int d = 8 * kk + t;
      const float x[4] = {rg ? rg[d] : 0.f, rg8 ? rg8[d] : 0.f, rg ? rg[d + 4] : 0.f,
                          rg8 ? rg8[d + 4] : 0.f};
#pragma unroll
      for (int r = 0; r < 4; ++r) tf32_split(x[r], qhi[kk][r], qlo[kk][r]);
    }
  }

  // three passes of 3xTF32 over four key columns at a time
  __device__ void qk(float (&s)[8][4], const T* ks, int lane) const {
#pragma unroll
    for (int h = 0; h < 4; ++h) {  // dims 16h .. 16h + 15: k-steps 2h, 2h+1
#pragma unroll
      for (int jg = 0; jg < 8; jg += 4) {
        uint32_t b[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ldmatrix_x4(b[j], ks + (8 * (jg + j) + lane % 8) * S + 16 * h + 4 * (lane / 8));
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int kk = 2 * h + u;
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tf32_split(__uint_as_float(b[j][2 * u]), bh[j][0], bl[j][0]);
            tf32_split(__uint_as_float(b[j][2 * u + 1]), bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(s[jg + j], qlo[kk], bh[j][0], bh[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(s[jg + j], qhi[kk], bl[j][0], bl[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(s[jg + j], qhi[kk], bh[j][0], bh[j][1]);
        }
      }
    }
  }

  __device__ void pv(float (&o)[8][4], const float (&p)[8][4], const float (&alpha)[2],
                     const T* vs, int lane) const {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int dh = 0; dh < 2; ++dh) {  // dims 32dh .. 32dh + 31
      float acc[4][4] = {};
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // keys 8j .. 8j + 7, read as 8j + {2t, 2t+1}
        uint32_t ah[4], al[4];
        tf32_split(p[j][0], ah[0], al[0]);  // row g,     key 2t   -> A column t
        tf32_split(p[j][2], ah[1], al[1]);  // row g + 8, key 2t
        tf32_split(p[j][1], ah[2], al[2]);  // row g,     key 2t+1 -> A column t + 4
        tf32_split(p[j][3], ah[3], al[3]);  // row g + 8, key 2t+1
        const T* v0 = vs + (8 * j + 2 * t) * S + 32 * dh + g;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          tf32_split(v0[8 * d], bh[d][0], bl[d][0]);
          tf32_split(v0[S + 8 * d], bh[d][1], bl[d][1]);
        }
#pragma unroll
        for (int d = 0; d < 4; ++d) mma_tf32(acc[d], al, bh[d][0], bh[d][1]);
#pragma unroll
        for (int d = 0; d < 4; ++d) mma_tf32(acc[d], ah, bl[d][0], bl[d][1]);
#pragma unroll
        for (int d = 0; d < 4; ++d) mma_tf32(acc[d], ah, bh[d][0], bh[d][1]);
      }
      rescale_add(o, 4 * dh, acc, alpha);
    }
  }

  __device__ static void store2(T* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// ------------------------------------------------------------ the kernel
// One row of a thread's two: where it reads and writes, its bias and mask.
struct RowState {
  bool in_range;  // a row of this block's tile
  bool live;      // a valid query
  int nb;         // n + offset: keys c <= nb take the lower slope
  int lim;        // valid keys are [0, lim)
  float lo2, hi2; // slopes in base 2
  uint32_t hseed; // dropout hash index of key 0, plus the seed
  float m, l;     // running max (base 2), this thread's share of the sum
};

// Rows is the row-geometry policy (see mqa_fwd.cu, flash_fwd.cu): built
// from the parameters and blockIdx, it gives the block's row count and,
// for tile row i, its query n, head h, q/o element offset, lse index and
// dropout hash base, the block's K/V base offset and key stride, and the
// bf16 blocks an SM its launch bound asks for.
// bf16 blocks are held to Rows::kBf16Blocks an SM (170 registers a thread
// for 3, 128 for 4); f32 blocks take what they need.
template <typename T, typename Rows>
__global__ void __launch_bounds__(FWD_THREADS, sizeof(T) == 2 ? Rows::kBf16Blocks : 1)
    attention_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  constexpr int S = kv_row<T>();
  constexpr int TILE = FWD_KEYS * S;
  T* ks = reinterpret_cast<T*>(fwd_smem);  // [2 stages][64 keys][S]
  T* vs = ks + 2 * TILE;

  const Rows rows(p);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int key_len = max(min(p.key_lens[rows.b], p.M), 0);
  const int q_len = min(p.q_lens[rows.b], p.N);
  const int nrows = rows.count();
  const bool drop = p.thresh < 256;
  const uint32_t thresh24 = static_cast<uint32_t>(p.thresh) << 24;  // keep: hash < this
  const uint32_t seed = static_cast<uint32_t>(p.seed[0]);
  const float scale2 = p.scale * LOG2E;

  // the keys a span of tile rows [i0, i1] needs: [0, kend)
  auto needed = [&](int i0, int i1) {
    if (i0 >= nrows || rows.query(i0) >= q_len) return 0;
    if (!p.causal) return key_len;
    const int n_last = min(rows.query(min(i1, nrows - 1)), q_len - 1);
    return min(key_len, max(n_last + p.offset + 1, 0));
  };
  const int block_kend = needed(0, FWD_ROWS - 1);
  const int w0 = 16 * warp;
  const int warp_kend = needed(w0, w0 + 15);
  // the warp's query span, for tiles that need no per-element compare
  const int wn_min = rows.query(min(w0, nrows - 1)) + p.offset;
  const int wn_max = rows.query(min(w0 + 15, nrows - 1)) + p.offset;

  RowState rs[2];
  Mma<T> mma;
  {
    const T* q = static_cast<const T*>(p.q);
    const T* qrow[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = w0 + g + 8 * half;
      RowState& r = rs[half];
      r.in_range = i < nrows;
      const int n = rows.query(i);
      const int h = r.in_range ? rows.head(i) : 0;
      r.live = r.in_range && n < q_len;
      r.nb = n + p.offset;
      r.lim = p.causal ? min(key_len, max(r.nb + 1, 0)) : key_len;
      r.lo2 = p.slopes[h] * LOG2E;
      r.hi2 = p.slopes[p.H + h] * LOG2E;
      r.hseed = rows.hash_base(i) + seed;
      r.m = FWD_NEG_INF;
      r.l = 0.f;
      qrow[half] = r.in_range && warp_kend > 0 ? q + rows.q_offset(i) : nullptr;
    }
    mma.load_q(qrow[0], qrow[1], t);
  }

  float o[8][4];
#pragma unroll
  for (int d = 0; d < 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  // K/V rows c0 .. c0 + 63 into a stage; rows past block_kend zero-filled
  const T* kb = static_cast<const T*>(p.k) + rows.kv_offset();
  const T* vb = static_cast<const T*>(p.v) + rows.kv_offset();
  const size_t kstride = rows.kv_stride();
  constexpr int CHUNKS = FWD_D * static_cast<int>(sizeof(T)) / 16;  // per row
  constexpr int PER = 16 / static_cast<int>(sizeof(T));            // elements
  auto load_tile = [&](int c0, int stage) {
#pragma unroll
    for (int u = 0; u < FWD_KEYS * CHUNKS / FWD_THREADS; ++u) {
      const int x = threadIdx.x + u * FWD_THREADS;
      const int j = x / CHUNKS, ch = x % CHUNKS;
      const int c = c0 + j;
      const bool ok = c < block_kend;
      const size_t src = (ok ? c : 0) * kstride + ch * PER;
      const int dst = stage * TILE + j * S + ch * PER;
      cp_async16(ks + dst, kb + src, ok);
      cp_async16(vs + dst, vb + src, ok);
    }
  };

  const int ntiles = (block_kend + FWD_KEYS - 1) / FWD_KEYS;
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < ntiles) load_tile((it + 1) * FWD_KEYS, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int c0 = it * FWD_KEYS;
    if (c0 < warp_kend) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma.qk(s, ks + stage * TILE, lane);

      // every key valid for every row, and all on one side of the diagonal
      const bool lower = c0 + FWD_KEYS - 1 <= wn_min;
      const bool upper = !p.causal && c0 > wn_max;
      const bool full = c0 + FWD_KEYS <= key_len && (lower || upper);
      float alpha[2];  // the rows' rescale of o by their new running max
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        RowState& r = rs[half];
        // element (j, e) is key c = c0 + 2t + 8j + e at distance d0 + 8j + e
        const int cb = c0 + 2 * t;
        const float d0 = static_cast<float>(cb - r.nb);  // c - n - offset
        const float sl = lower ? r.lo2 : -r.hi2;
        float mt = FWD_NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dist = d0 + static_cast<float>(8 * j + e);  // exact
            float x;
            if (full) {
              x = fmaf(s[j][2 * half + e], scale2, sl * dist);
            } else {
              const float slope = dist <= 0.f ? r.lo2 : -r.hi2;
              x = cb + 8 * j + e < r.lim ? fmaf(s[j][2 * half + e], scale2, slope * dist)
                                         : FWD_NEG_INF;
            }
            s[j][2 * half + e] = x;
            mt = fmaxf(mt, x);
          }
        }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(r.m, mt);
        alpha[half] = fast_exp2(r.m - m_new);
        r.m = m_new;
        // a masked logit is FWD_NEG_INF, whose exp2 is 0 against any finite
        // max; a row with no valid key yet takes 0 as its max instead
        const float m_use = m_new == FWD_NEG_INF ? 0.f : m_new;
        float lsum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * half + e];
            x = fast_exp2(x - m_use);
            lsum += x;
          }
        }
        r.l = r.l * alpha[half] + lsum;
        if (drop) {  // the normaliser keeps the undropped probabilities
          const uint32_t u0 = (r.hseed + static_cast<uint32_t>(cb)) * KEEP_MUL;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t u = keep_mix(u0 + static_cast<uint32_t>(8 * j + e) * KEEP_MUL);
              if (u >= thresh24) s[j][2 * half + e] = 0.f;
            }
          }
        }
      }
      mma.pv(o, s, alpha, vs + stage * TILE, lane);
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }

  T* out = static_cast<T*>(p.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const RowState& r = rs[half];
    float l = r.l;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!r.in_range) continue;
    const int i = w0 + g + 8 * half;
    const bool ok = r.live && l > 0.f;
    const float inv = ok ? p.inv_keep / l : 0.f;  // dropout's 1/(1 - rate) here
    T* orow = out + rows.q_offset(i);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      Mma<T>::store2(orow + 8 * d + 2 * t, o[d][2 * half] * inv, o[d][2 * half + 1] * inv);
    }
    if (t == 0) p.lse[rows.lse_index(i)] = ok ? (r.m + log2f(l)) * LN2 : INFINITY;
  }
}

// Launch one instantiation on `st` with its dynamic shared memory. In f32
// that is above the 48 KB default, so the limit is raised first, once per
// device (a repeated raise is harmless, so the flags need no lock); the
// launch itself makes no other runtime call, so it can be captured in a
// CUDA graph. Returns the CUDA error of the attribute call or the launch.
template <typename T, typename Rows>
cudaError_t launch_attention_fwd(dim3 grid, const FwdParams& p, cudaStream_t st) {
  auto kernel = attention_fwd_kernel<T, Rows>;
  constexpr int bytes = fwd_smem_bytes<T>();
  if (bytes > 48 * 1024) {
    static unsigned long long raised = 0;  // bit d: device d's limit is set
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev >= 64 || !((raised >> dev) & 1ull))) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err == cudaSuccess && dev < 64) raised |= 1ull << dev;
    }
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, FWD_THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
