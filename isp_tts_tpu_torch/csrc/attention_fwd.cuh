// The attention forward tile core shared by K1 (mqa_fwd.cu, folded rows on
// one key/value head) and K5a (flash_fwd.cu, one head per block): one
// templated kernel on Hopper's tensor cores through mma.sync, with the
// row geometry supplied by a small policy.
//
// Block: 4 warps (128 threads) over 64 query rows, 16 rows a warp. Key and
// value tiles of 64 keys x DT columns (the tile width of attention_common.cuh,
// columns past the head dim zero-filled by the copy) arrive in shared memory
// by cp.async, double buffered, so that tile j+1 loads while tile j is in
// the MMAs; nothing is widened in shared memory (rows padded by one 16-byte
// chunk, so ldmatrix and the f32 value reads are free of bank conflicts).
// Each warp keeps its Q tile as A fragments in registers, loaded once, and
// its 16 x 64 logits and 16 x DT output accumulator in registers: the
// logits' fragment element
// (row lane/4 or lane/4 + 8, column 2*(lane%4) + {0,1}) is where the bias,
// the masks, the dropout hash and the online softmax act, in f32 on the
// CUDA cores, and the same registers become the A fragment of P.V.
//
// The products (Q.K^T and P.V) are attention_mma.cuh's qk and pv: bf16
// mma.m16n8k16 with P split as p_hi + p_lo, since _fwd_kernel (K5a's TPU
// kernel) runs P.V in f32; _mqa_fwd_kernel (K1's) rounds P to bf16, and in
// one bf16 training step that rounding put the kernel path twice as far
// from the plain path as the split does (PERF.md §6), so K1 splits as K5a
// does. f32 is 3xTF32 mma.m16n8k8. Each tile's P.V is summed in fresh
// fragments and added on the CUDA cores, so a long key loop does not drift.
//
// The softmax runs in base 2 (logits and slopes pre-multiplied by log2 e,
// one ex2.approx per probability); lse is returned in natural units. Per
// element the distance is one add off a per-row base (exact in f32), the
// dropout hash one add off a per-row product (it is linear in the key
// before its mix), and 1/(1 - rate) is applied once, to the output.
//
// The tile width: at DT = 128 the output accumulator alone is 64 registers a
// thread and the bf16 Q fragments 32, so a bf16 block is held to 2 an SM
// (255 registers) rather than 3 or 4; its K and V stages take 2 x 2 x 64 x
// (128 + 8) x 2 bytes = 70 KB. f32 at DT = 128 runs its own kernel
// (attention_fwd_kernel_staged, below): kept resident, Q's f32 values were
// 64 registers a thread more, the kernel spilled ~900 bytes a thread, and
// its double-buffered K and V took 135 KB, one block an SM.
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

#include "attention_mma.cuh"

namespace {

// bf16 P.V terms: p_hi + p_lo (1 would round P to bf16)
constexpr int FWD_P_TERMS = 2;

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
  int hash_heads;       // the dropout index's head count (H on one rank)
  uint32_t seed_shift;  // the dropout index of this call's first element
  int D;                // head dim: a multiple of 8, at most the tile width
};

// The staged kernel's per-thread words in shared memory: for each of a
// thread's two rows nb, the two slopes and the hash index of RowState and
// a flag (0 a row past the tile, 1 a dead query, 2 a live one); then the
// output accumulator's last FWD_SHARED_SLICES 8-column slices.
constexpr int FWD_SHARED_SLICES = 4;
constexpr int FWD_ROW_WORDS = (2 * 5 + 4 * FWD_SHARED_SLICES) * ATT_THREADS;

// Dynamic shared memory of one block: two stages of K and of V; the staged
// kernel's K/V tile, its lo tile, Q's rows and the per-thread words.
template <typename T, int DT>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return FwdMma<T, DT>::kStagedQ
             ? (2 * ATT_KEYS + ATT_ROWS) * tile_row<T, DT>() * 4 + FWD_ROW_WORDS * 4
             : 4 * ATT_KEYS * tile_row<T, DT>() * static_cast<int>(sizeof(T));
}

// The same for the entry points' dtype code (0 f32, 1 bf16), 0 for another.
template <int DT>
inline int fwd_smem_bytes_of(int dtype) {
  return dtype == 0   ? fwd_smem_bytes<float, DT>()
         : dtype == 1 ? fwd_smem_bytes<__nv_bfloat16, DT>()
                      : 0;
}

// Blocks an SM the launch bound asks for: bf16 Rows::kBf16Blocks up to
// DT = 64, 2 at DT = 128 (255 registers a thread); f32 blocks take what
// they need.
template <typename T, int DT, typename Rows>
__host__ __device__ constexpr int fwd_min_blocks() {
  return sizeof(T) != 2 ? 1 : DT > 64 ? 2 : Rows::kBf16Blocks;
}

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

// Rows is a row-stationary geometry of attention_common.cuh (FoldedRows,
// HeadRows), DT the tile width, kFullD whether D == DT. bf16 blocks are held
// to fwd_min_blocks an SM (170 registers a thread for 3, 128 for 4, 255 for
// 2).
template <typename T, int DT, bool kFullD, typename Rows>
__global__ void __launch_bounds__(ATT_THREADS, fwd_min_blocks<T, DT, Rows>())
    attention_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  using Ops = typename FwdMma<T, DT>::type;
  constexpr int S = tile_row<T, DT>();
  constexpr int DS = DT / 8;  // 8-column slices of the output
  constexpr int TILE = ATT_KEYS * S;
  T* ks = reinterpret_cast<T*>(fwd_smem);  // [2 stages][64 keys][S]
  T* vs = ks + 2 * TILE;

  const int D = kFullD ? DT : p.D;  // the head dim
  const Rows rows(p, D);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int key_len = max(min(p.key_lens[rows.b], p.M), 0);
  const int q_len = min(p.q_lens[rows.b], p.N);
  const int nrows = rows.count();
  const bool drop = p.thresh < 256;
  const uint32_t thresh24 = static_cast<uint32_t>(p.thresh) << 24;  // keep: hash < this
  const uint32_t seed = static_cast<uint32_t>(p.seed[0]) + p.seed_shift;
  const float scale2 = p.scale * LOG2E;

  // the keys a span of tile rows [i0, i1] needs: [0, kend)
  auto needed = [&](int i0, int i1) {
    if (i0 >= nrows || rows.query(i0) >= q_len) return 0;
    if (!p.causal) return key_len;
    const int n_last = min(rows.query(min(i1, nrows - 1)), q_len - 1);
    return min(key_len, max(n_last + p.offset + 1, 0));
  };
  const int block_kend = needed(0, ATT_ROWS - 1);
  const int w0 = 16 * warp;
  const int warp_kend = needed(w0, w0 + 15);
  // the warp's query span, for tiles that need no per-element compare
  const int wn_min = rows.query(min(w0, nrows - 1)) + p.offset;
  const int wn_max = rows.query(min(w0 + 15, nrows - 1)) + p.offset;

  RowState rs[2];
  Ops mma;
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
      r.m = ATT_NEG_INF;
      r.l = 0.f;
      qrow[half] = r.in_range && warp_kend > 0 ? q + rows.q_offset(i) : nullptr;
    }
    mma.load_q(qrow[0], qrow[1], t, D);
  }

  float o[DS][4];
#pragma unroll
  for (int d = 0; d < DS; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  // K/V rows c0 .. c0 + 63 into a stage; rows past block_kend and columns
  // past D zero-filled
  const T* kb = static_cast<const T*>(p.k) + rows.kv_offset();
  const T* vb = static_cast<const T*>(p.v) + rows.kv_offset();
  const size_t kstride = rows.kv_stride();
  constexpr int CHUNKS = DT * static_cast<int>(sizeof(T)) / 16;  // per tile row
  constexpr int PER = 16 / static_cast<int>(sizeof(T));         // elements
  auto load_tile = [&](int c0, int stage) {
#pragma unroll
    for (int u = 0; u < ATT_KEYS * CHUNKS / ATT_THREADS; ++u) {
      const int x = threadIdx.x + u * ATT_THREADS;
      const int j = x / CHUNKS, ch = x % CHUNKS;
      const int c = c0 + j;
      const bool ok = c < block_kend && ch * PER < D;
      const size_t src = ok ? c * kstride + ch * PER : 0;
      const int dst = stage * TILE + j * S + ch * PER;
      cp_async16(ks + dst, kb + src, ok);
      cp_async16(vs + dst, vb + src, ok);
    }
  };

  const int ntiles = (block_kend + ATT_KEYS - 1) / ATT_KEYS;
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < ntiles) load_tile((it + 1) * ATT_KEYS, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int c0 = it * ATT_KEYS;
    if (c0 < warp_kend) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma.qk(s, ks + stage * TILE, lane);

      // every key valid for every row, and all on one side of the diagonal
      const bool lower = c0 + ATT_KEYS - 1 <= wn_min;
      const bool upper = !p.causal && c0 > wn_max;
      const bool full = c0 + ATT_KEYS <= key_len && (lower || upper);
      float alpha[2];  // the rows' rescale of o by their new running max
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        RowState& r = rs[half];
        // element (j, e) is key c = c0 + 2t + 8j + e at distance d0 + 8j + e
        const int cb = c0 + 2 * t;
        const float d0 = static_cast<float>(cb - r.nb);  // c - n - offset
        const float sl = lower ? r.lo2 : -r.hi2;
        float mt = ATT_NEG_INF;
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
                                         : ATT_NEG_INF;
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
        // a masked logit is ATT_NEG_INF, whose exp2 is 0 against any finite
        // max; a row with no valid key yet takes 0 as its max instead
        const float m_use = m_new == ATT_NEG_INF ? 0.f : m_new;
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
      Ops::template pv<FWD_P_TERMS>(o, s, alpha, vs + stage * TILE, lane);
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
    for (int d = 0; d < DS; ++d) {
      if (8 * d < D) {
        Ops::store2(orow + 8 * d + 2 * t, o[d][2 * half] * inv, o[d][2 * half + 1] * inv);
      }
    }
    if (t == 0) p.lse[rows.lse_index(i)] = ok ? (r.m + log2f(l)) * LN2 : INFINITY;
  }
}

// ------------------------------------------- the f32 kernel at DT = 128
// The same function as attention_fwd_kernel, for f32 at DT = 128, where
// resident Q and two stages of K and V do not fit the registers and two
// blocks' shared memory:
// - the block's 64 Q rows are staged in shared memory once (33 KB), and qk
//   reads and splits each k-step's fragment there (FwdMma's MmaTf32Wide);
// - K and V take turns in one 64-key tile (33 KB), and each is split there
//   once for the block, hi over the tile and lo into a second one (33 KB;
//   MmaTf32Wide::split_tile), where the other kernel's warps each split
//   every K and V value they read. K of tile j+1 loads after tile j's
//   P.V, V of tile j while tile j's probabilities are computed. Q, the two
//   tiles and the per-thread words below take 112 KB, so two blocks share
//   an SM (8 warps; the serving decoder's 192 blocks, B 4 x 1024 rows x 3
//   heads, run in one wave), and one block's loads run under the other's
//   products;
// - the copy loops stay rolled: unrolled, their hoisted addresses cost
//   registers the kernel does not have at 255 a thread; for the same
//   reason each thread's row constants (nb, slopes, hash index, a flag for
//   the end) and the last four of its 16 output slices wait in shared
//   memory (13 KB; FWD_SHARED_SLICES): two blocks' shared memory leaves
//   room for no more, and the registers for no fewer;
// - P.V reads V rows as 16-byte vectors (MmaTf32Wide's interleaved output
//   columns), and the epilogue stores o as 16-byte vectors through
//   column().
// The key tile stays 64 wide and every split and sum is the other
// kernel's, so on the same numbers (zero columns added) o and lse equal
// the D = 64 kernel's bit for bit. The per-element work below is
// attention_fwd_kernel's.
template <int DT, bool kFullD, typename Rows>
__global__ void __launch_bounds__(ATT_THREADS, 2)
    attention_fwd_kernel_staged(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  using T = float;
  using Ops = typename FwdMma<T, DT>::type;
  constexpr int S = tile_row<T, DT>();
  constexpr int DS = DT / 8;  // 8-column slices of the output
  constexpr int DR = DS - FWD_SHARED_SLICES;  // those in registers
  constexpr int TILE = ATT_KEYS * S;
  T* kv = reinterpret_cast<T*>(fwd_smem);  // [64 keys][S]: K or V, then its hi
  T* lo = kv + TILE;                       // [64 keys][S]: its lo
  T* qs = lo + TILE;                       // [64 rows][S]
  // [half][nb, lo2, hi2, hseed, flag][thread], then [slice d - DR][4][thread]
  uint32_t* rc = reinterpret_cast<uint32_t*>(qs + ATT_ROWS * S) + threadIdx.x;
  float* os = reinterpret_cast<float*>(rc + 10 * ATT_THREADS);

  const int D = kFullD ? DT : p.D;  // the head dim
  const Rows rows(p, D);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int key_len = max(min(p.key_lens[rows.b], p.M), 0);
  const int q_len = min(p.q_lens[rows.b], p.N);
  const int nrows = rows.count();
  const bool drop = p.thresh < 256;
  const uint32_t thresh24 = static_cast<uint32_t>(p.thresh) << 24;  // keep: hash < this
  const uint32_t seed = static_cast<uint32_t>(p.seed[0]) + p.seed_shift;
  const float scale2 = p.scale * LOG2E;

  // the keys a span of tile rows [i0, i1] needs: [0, kend)
  auto needed = [&](int i0, int i1) {
    if (i0 >= nrows || rows.query(i0) >= q_len) return 0;
    if (!p.causal) return key_len;
    const int n_last = min(rows.query(min(i1, nrows - 1)), q_len - 1);
    return min(key_len, max(n_last + p.offset + 1, 0));
  };
  const int block_kend = needed(0, ATT_ROWS - 1);
  const int w0 = 16 * warp;
  const int warp_kend = needed(w0, w0 + 15);
  // the warp's query span, for tiles that need no per-element compare
  const int wn_min = rows.query(min(w0, nrows - 1)) + p.offset;
  const int wn_max = rows.query(min(w0 + 15, nrows - 1)) + p.offset;

  float m[2], l[2];  // the rows' running max (base 2) and this thread's share of the sum
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = w0 + g + 8 * half;
    const int n = rows.query(i);
    const int h = i < nrows ? rows.head(i) : 0;
    const int nb = n + p.offset;
    uint32_t* c = rc + 5 * ATT_THREADS * half;
    c[0] = static_cast<uint32_t>(nb);
    c[ATT_THREADS] = __float_as_uint(p.slopes[h] * LOG2E);
    c[2 * ATT_THREADS] = __float_as_uint(p.slopes[p.H + h] * LOG2E);
    c[3 * ATT_THREADS] = rows.hash_base(i) + seed;
    c[4 * ATT_THREADS] = i >= nrows ? 0u : n < q_len ? 2u : 1u;
    m[half] = ATT_NEG_INF;
    l[half] = 0.f;
  }
  Ops mma;
  mma.bind(qs + w0 * S, lane);

  float o[DR][4];
#pragma unroll
  for (int d = 0; d < DR; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
  for (int x = 0; x < 4 * FWD_SHARED_SLICES; ++x) os[x * ATT_THREADS] = 0.f;
  // output slice d's element r: in registers, or in shared memory from DR on
  auto out = [&](int d, int r) { return d < DR ? o[d][r] : os[(4 * (d - DR) + r) * ATT_THREADS]; };

  const T* q = static_cast<const T*>(p.q);
  // the block's K/V rows: one offset from both parameters, and the key
  // stride (Hkv * D) in 32 bits
  const size_t kvo = rows.kv_offset();
  const int kstride = static_cast<int>(rows.kv_stride());
  const T* kb = static_cast<const T*>(p.k) + kvo;
  const T* vb = static_cast<const T*>(p.v) + kvo;
  constexpr int CHUNKS = DT / 4;  // 16-byte chunks a row
  // 64 rows into a shared tile, row i from `row(i)` (null: zeros), columns
  // past D zero-filled; `base` any address of the operand
  auto stage = [&](T* dst, const T* base, auto row) {
#pragma unroll 1
    for (int u = 0; u < ATT_ROWS * CHUNKS / ATT_THREADS; ++u) {
      const int x = threadIdx.x + u * ATT_THREADS;
      const int i = x / CHUNKS, ch = x % CHUNKS;
      const T* src = row(i);
      const bool ok = src != nullptr && 4 * ch < D;
      cp_async16(dst + i * S + 4 * ch, ok ? src + 4 * ch : base, ok);
    }
  };
  // K or V rows c0 .. c0 + 63, zero past block_kend, as one commit group
  auto stage_keys = [&](T* dst, const T* base, int c0) {
    stage(dst, base, [&](int i) {
      return c0 + i < block_kend ? base + static_cast<size_t>(c0 + i) * kstride : nullptr; });
    cp_async_commit();
  };

  // one commit group at a time: Q with K of tile 0, then V of each tile and
  // K of the next as the tile frees
  if (block_kend > 0) {
    stage(qs, q, [&](int i) { return i < nrows ? q + rows.q_offset(i) : nullptr; });
    stage_keys(kv, kb, 0);
  }
  for (int c0 = 0; c0 < block_kend; c0 += ATT_KEYS) {
    const bool mine = c0 < warp_kend;
    float s[8][4];
    float alpha[2];  // the rows' rescale of o by their new running max
    cp_async_wait<0>();  // K (and Q)
    __syncthreads();
    Ops::split_tile(kv, lo);
    __syncthreads();
    if (mine) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma.qk(s, kv, lo, lane);
    }
    __syncthreads();  // the tile is free
    stage_keys(kv, vb, c0);
    if (mine) {
      // every key valid for every row, and all on one side of the diagonal
      const bool lower = c0 + ATT_KEYS - 1 <= wn_min;
      const bool upper = !p.causal && c0 > wn_max;
      const bool full = c0 + ATT_KEYS <= key_len && (lower || upper);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t* c = rc + 5 * ATT_THREADS * half;
        RowState r;
        r.nb = static_cast<int>(c[0]);
        r.lim = p.causal ? min(key_len, max(r.nb + 1, 0)) : key_len;
        r.lo2 = __uint_as_float(c[ATT_THREADS]);
        r.hi2 = __uint_as_float(c[2 * ATT_THREADS]);
        r.hseed = c[3 * ATT_THREADS];
        r.m = m[half];
        r.l = l[half];
        // element (j, e) is key c = c0 + 2t + 8j + e at distance d0 + 8j + e
        const int cb = c0 + 2 * t;
        const float d0 = static_cast<float>(cb - r.nb);  // c - n - offset
        const float sl = lower ? r.lo2 : -r.hi2;
        float mt = ATT_NEG_INF;
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
                                         : ATT_NEG_INF;
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
        // a masked logit is ATT_NEG_INF, whose exp2 is 0 against any finite
        // max; a row with no valid key yet takes 0 as its max instead
        const float m_use = m_new == ATT_NEG_INF ? 0.f : m_new;
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
        m[half] = r.m;
        l[half] = r.l;
      }
    }
    cp_async_wait<0>();  // V
    __syncthreads();
    Ops::split_tile(kv, lo);
    __syncthreads();
    if (mine) {
      Ops::pv(s, kv, lo, lane, [&](int d0, const float (&acc)[Ops::G][4]) {
#pragma unroll
        for (int i = 0; i < Ops::G; ++i) {  // rescale_add
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int d = d0 + i;
            if (d < DR) {
              o[d][r] = fmaf(o[d][r], alpha[r / 2], acc[i][r]);
            } else {
              float& x = os[(4 * (d - DR) + r) * ATT_THREADS];
              x = fmaf(x, alpha[r / 2], acc[i][r]);
            }
          }
        }
      });
    }
    __syncthreads();  // the tile is free
    if (c0 + ATT_KEYS < block_kend) stage_keys(kv, kb, c0 + ATT_KEYS);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const uint32_t flag = rc[(5 * half + 4) * ATT_THREADS];
    if (flag == 0) continue;
    const int i = w0 + g + 8 * half;
    const bool ok = flag == 2 && sum > 0.f;
    const float inv = ok ? p.inv_keep / sum : 0.f;  // dropout's 1/(1 - rate) here
    T* orow = static_cast<T*>(p.o) + rows.q_offset(i);
    // slices d .. d + 3 hold columns c .. c + 3 at fragment column 2t and
    // c + 4 .. c + 7 at 2t + 1 (MmaTf32Wide::column): two 16-byte stores
#pragma unroll
    for (int d = 0; d < DS; d += 4) {
      const int c = Ops::column(d, 2 * t);
      if (c < D) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          *reinterpret_cast<float4*>(orow + c + 4 * e) =
              make_float4(out(d, 2 * half + e) * inv, out(d + 1, 2 * half + e) * inv,
                          out(d + 2, 2 * half + e) * inv, out(d + 3, 2 * half + e) * inv);
        }
      }
    }
    if (t == 0) p.lse[rows.lse_index(i)] = ok ? (m[half] + log2f(sum)) * LN2 : INFINITY;
  }
}

// The kernel of an instantiation: the staged one for f32 at DT = 128.
template <typename T, int DT, bool kFullD, typename Rows>
constexpr auto fwd_kernel() {
  if constexpr (FwdMma<T, DT>::kStagedQ) {
    return attention_fwd_kernel_staged<DT, kFullD, Rows>;
  } else {
    return attention_fwd_kernel<T, DT, kFullD, Rows>;
  }
}

// Launch one instantiation on `st` with its dynamic shared memory (the
// limit raised once per device, so the launch can be captured in a CUDA
// graph). Returns the CUDA error of the attribute call or the launch.
template <typename T, int DT, bool kFullD, typename Rows>
cudaError_t launch_fwd_kernel(dim3 grid, const FwdParams& p, cudaStream_t st) {
  constexpr auto kernel = fwd_kernel<T, DT, kFullD, Rows>();
  constexpr int bytes = fwd_smem_bytes<T, DT>();
  const cudaError_t err = raise_smem_once<kernel>(bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ATT_THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

// Blocks of one instantiation that fit an SM of the current device, as the
// occupancy calculator counts them from its registers and its dynamic
// shared memory (the limit raised as a launch raises it); -1 on a CUDA
// error.
template <typename T, int DT, bool kFullD, typename Rows>
int fwd_blocks_per_sm() {
  constexpr auto kernel = fwd_kernel<T, DT, kFullD, Rows>();
  constexpr int bytes = fwd_smem_bytes<T, DT>();
  int blocks = 0;
  if (raise_smem_once<kernel>(bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, ATT_THREADS, bytes) !=
          cudaSuccess) {
    return -1;
  }
  return blocks;
}

// The same for the entry points' dtype code (0 f32, 1 bf16) and `full`
// (the D == DT instantiation, else D < DT); -1 for another dtype.
template <int DT, typename Rows>
inline int fwd_blocks_per_sm_of(int dtype, int full) {
  if (dtype == 0) {
    return full ? fwd_blocks_per_sm<float, DT, true, Rows>()
                : fwd_blocks_per_sm<float, DT, false, Rows>();
  }
  if (dtype == 1) {
    return full ? fwd_blocks_per_sm<__nv_bfloat16, DT, true, Rows>()
                : fwd_blocks_per_sm<__nv_bfloat16, DT, false, Rows>();
  }
  return -1;
}

// The instantiation for p.D: the full-width one at D == DT.
template <typename T, int DT, typename Rows>
cudaError_t launch_attention_fwd(dim3 grid, const FwdParams& p, cudaStream_t st) {
  return p.D == DT ? launch_fwd_kernel<T, DT, true, Rows>(grid, p, st)
                   : launch_fwd_kernel<T, DT, false, Rows>(grid, p, st);
}

}  // namespace
