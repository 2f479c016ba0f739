// The attention backward tile core shared by K2 (mqa_bwd.cu, folded rows
// on one key/value head) and K5b (flash_bwd.cu, one head per block of
// rows): two templated kernels on Hopper's tensor cores through mma.sync,
// with the row geometry supplied by the policies of attention_common.cuh.
//
// From the forward's o and lse (+inf on dead rows, so p = 0 there), with
// s the forward's logits (base 2 here: scale and slopes times log2 e):
//   delta = rowsum(dO * O)                p  = exp2(s - lse * log2 e)
//   dp    = dO . V^T (* keep / (1-rate))  ds = p * (dp - delta)
//   dV    = sum_rows p * keep/(1-rate) . dO
//   dQ    = scale * dS . K                dK = scale * sum_rows dS^T . Q
//   dslope[lower|upper][h] = sum ds * -|c - c*| over that triangle, c*
//     the valid key nearest n + offset: c* = n + offset where the row's
//     valid keys straddle it, and -|c - c*| the ALiBi distance; where they
//     all lie on one side (a far offset, a query past the key length) the
//     two differ by a constant of the row, over which ds sums to zero.
//     Summed over the ALiBi distance, delta's error (o is the forward's
//     rounded output) times that constant, up to |offset|, swamps the sum
//     (1e-2 of it in f32, O(1) in bf16 at offset -832 on an H100)
// Two passes, both deterministic, no float atomics on dq, dk or dv:
//   1. dq pass, row-stationary: one block of 4 warps per 64 rows (the
//      forward's blocks); each warp keeps its 16 rows' Q and dO as A
//      fragments. 64-key K/V tiles arrive by cp.async, double buffered; per
//      tile S = Q.K^T and dP = dO.V^T (qk), dS in S's registers, dQ += dS.K
//      (pv, K read transposed). It writes delta for pass 2 and sums the
//      slope gradients: per element ds * (c - c*) by triangle, per row in
//      registers, over the block in a fixed order, into the block's
//      partials, which a small launch sums over the blocks in a fixed order
//      (no float atomics: a call's dslopes are the same bits on every run,
//      so a training run resumed from a checkpoint retraces the
//      uninterrupted one). The terms of a slope's sum (B * N * M of them)
//      cancel to a small total, so in the f32 kernels this pass
//      takes each logit less lse in float64 (the slopes, the scale and lse
//      in float64): the rounding of their base-2 forms, one per head and
//      one per row, enters every term of a head or row alike and piled up
//      coherently over the sum, to 1.6x the plain version's distance from
//      float64 (PERF.md section 6; float64 sums of the f32 logits' terms
//      did not move that). The bf16 kernels keep f32 logits (their register
//      budget is spent).
//   2. dk/dv pass, key-stationary: one block per 64 keys (and per head,
//      K5b with Hkv = H), each warp keeping its 16 keys' K and V as A
//      fragments. Row tiles of 64 queries of one head (Q, dO, lse, delta)
//      arrive by cp.async, double buffered; per tile (bf16: per half tile
//      of 32 rows, since the logits of a whole tile, the dK and dV sums
//      and the split of P would not fit a thread's 255 registers) S^T = K.Q^T and
//      dP^T = V.dO^T (qk, keys as the MMA rows), so P^T and dS^T sit in
//      accumulator registers and feed dV += P^T.dO and dK += dS^T.Q (pv)
//      as A operands. K2 and K5b at Hkv = 1 walk every head's rows of their
//      keys; the walk is split over `splits` blocks, whose f32 partial sums
//      a third launch adds in a fixed order.
//
// The logits are the forward's (attention_fwd.cuh): the same products
// (attention_mma.cuh: bf16 mma.m16n8k16 with exact products, f32 3xTF32;
// pass 2 takes the transposed product, the same terms), the same
// fmaf(s, scale * log2 e, slope * log2 e * dist) and ex2.approx, and lse
// converted to base 2 once per row, so p sums to 1 against the forward's
// lse. bf16 P, dS and P^T, dS^T go into pv as hi + lo bf16 terms, since
// _dq_kernel and _dkv_kernel (K5b's TPU kernels) run those products in f32;
// _mqa_dfused_kernel (K2's) rounds p and ds to bf16, which doubled the bf16
// step gate's reading for the forward's P (PERF.md §6). Every tile's
// product is summed in fresh fragments and added on the CUDA cores, so dK
// and dV do not drift over a long row loop.
//
// Per element the distance is one add off a per-row (pass 1) or per-key
// (pass 2) base, the dropout hash one add off a base (it is linear in the
// key and the row before its mix). A tile wholly inside the key length
// (and, pass 2, the query length) and wholly on one side of every pair's
// diagonal skips the compares; tiles past a block's last needed key (pass
// 1) or before its first needed query (pass 2, causal) are neither loaded
// nor computed.
//
// The tile width DT (attention_common.cuh): every tile is 64 rows x DT
// columns, zero past the head dim. Up to DT = 64 each warp holds its two A
// operands (Q and dO in pass 1, K and V in pass 2) as fragments in
// registers, as described above. At DT = 128 the accumulators alone fill
// a thread: pass 1's dQ sum is 64 registers, pass 2's dK and dV sums 128,
// and resident A operands would add 64 (bf16) or 128 (f32) more. So at
// DT = 128 both passes stage their A operands' 64 rows in shared memory
// once per block (Q and dO, or K and V: 2 x 64 x (128 + pad) elements,
// 34 KB bf16, 68 KB f32, beside the double-buffered tiles) and each warp
// reads a k-step's fragment there as it goes (BwdMma, attention_mma.cuh's
// shared A operand); pass 2 walks half tiles of 32 rows in f32 too. dK and
// dV stay in registers, summed in a fixed order, with no float atomics: a
// bf16 block then holds 160 accumulator and logit registers of its 255
// (2 blocks an SM, 105 KB of shared memory each); f32 spills some (ptxas's
// counts in chip_smoke.py's build phase). Splitting the columns over two
// warps would recompute S^T and dP^T twice, and dK/dV in shared memory
// would put a read-modify-write of 2 x 16 x 128 f32 on every row tile.
//
// Include only from the backward sources: every includer is its own
// translation unit, so the helpers sit in an anonymous namespace.

#pragma once

#include "attention_mma.cuh"

namespace {

constexpr double LOG2E_D = 1.4426950408889634;

// bf16 P and dS terms in pv: hi + lo (1 would round them to bf16)
constexpr int BWD_TERMS = 2;
// bf16 blocks an SM of both passes (255 registers a thread); at 3 (168
// registers) each pass spills (PERF.md §6)
constexpr int BWD_BF16_BLOCKS = 2;

// The arguments both entry points take, as the kernels read them.
struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* slopes;  // (2, H): lower, upper
  const int* key_lens;
  const int* q_lens;
  const int* seed;
  const void* o;
  const float* lse;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* dslopes;  // (2, H), then the dq pass's partials [2][H][slope_parts], zeroed by the caller
  float* delta;    // lse's layout, written by pass 1
  float* work;     // splits > 1: [splits][dk, dv][k's elements] f32
  int B, N, M, H, Hkv, offset, causal;
  float scale;
  int thresh;
  float inv_keep;
  int splits;
  int hash_heads;       // the dropout index's head count (H on one rank)
  uint32_t seed_shift;  // the dropout index of this call's first element
  int D;                // head dim: a multiple of 8, at most the tile width
  int slope_parts;      // the dq pass's (batch, row block) pairs: B * grid1.x
};

// Whether the A operands sit in shared memory at this tile width.
template <int DT>
__host__ __device__ constexpr bool bwd_shared_a() {
  return DT > 64;
}

// The A operands of the backward: f32 keeps its values and splits at each
// use, since each warp holds two operands (Q and dO, or K and V); at
// DT = 128 both dtypes read them from shared memory.
template <typename T, int DT>
struct BwdMma {
  using type = MmaBf16<DT, bwd_shared_a<DT>()>;
};
template <int DT>
struct BwdMma<float, DT> {
  using type = MmaTf32<false, DT, bwd_shared_a<DT>()>;
};

// Rows a warp of pass 2 takes at once: half a tile in bf16 (a whole tile's
// logits, the dK and dV sums and the split of P would spill), and in f32
// at DT = 128; f32 spills either way up to DT = 64 and runs faster on whole
// tiles there.
template <typename T, int DT>
__host__ __device__ constexpr int dkv_part() {
  return sizeof(T) == 2 || DT > 64 ? ATT_KEYS / 2 : ATT_KEYS;
}

// Dynamic shared memory of a block: pass 1, two stages of K and of V (and
// at DT = 128 the block's Q and dO rows); pass 2, two stages of Q and of
// dO rows and of their lse and delta (and at DT = 128 the block's K and V
// rows).
template <typename T, int DT>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (4 * ATT_KEYS + (bwd_shared_a<DT>() ? 2 * ATT_ROWS : 0)) * tile_row<T, DT>() *
         static_cast<int>(sizeof(T));
}
template <typename T, int DT>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return (4 * ATT_KEYS + (bwd_shared_a<DT>() ? 2 * ATT_ROWS : 0)) * tile_row<T, DT>() *
             static_cast<int>(sizeof(T)) +
         4 * ATT_KEYS * static_cast<int>(sizeof(float));
}

// The larger of the two for the entry points' dtype code (0 f32, 1 bf16).
template <int DT>
inline int bwd_smem_bytes_of(int dtype) {
  return dtype == 0   ? dkv_smem_bytes<float, DT>()
         : dtype == 1 ? dkv_smem_bytes<__nv_bfloat16, DT>()
                      : 0;
}

// 64 rows of a (rows x D) operand into a shared (64 x S) tile by cp.async,
// row i from `row(i)` (null: a row past the operand), zero past D and on
// null rows; `base` is any valid address of the operand, the source named
// where nothing is read. The caller commits.
template <typename T, int DT, typename RowFn>
__device__ __forceinline__ void stage_rows(T* dst, const T* base, RowFn row, int D) {
  constexpr int S = tile_row<T, DT>();
  constexpr int CHUNKS = DT * static_cast<int>(sizeof(T)) / 16;
  constexpr int PER = 16 / static_cast<int>(sizeof(T));
#pragma unroll
  for (int u = 0; u < ATT_ROWS * CHUNKS / ATT_THREADS; ++u) {
    const int x = threadIdx.x + u * ATT_THREADS;
    const int i = x / CHUNKS, ch = x % CHUNKS;
    const T* src = row(i);
    const bool ok = src != nullptr && ch * PER < D;
    cp_async16(dst + i * S + ch * PER, ok ? src + ch * PER : base, ok);
  }
}

// --------------------------------------------------------------- pass 1
// One row of a thread's two in the dq pass: its bias, mask and saved stats.
struct BwdRow {
  bool in_range;   // a row of this block's tile
  int nb;          // n + offset: keys c <= nb take the lower slope
  int lim;         // valid keys are [0, lim)
  float lo2, hi2;  // slopes in base 2
  uint32_t hseed;  // dropout hash index of key 0, plus the seed
  float lse2;      // lse in base 2 (+inf: a dead row)
  float delta;     // rowsum(dO * O)
  double lo2d, hi2d, lse2d;  // f32 kernels: the same from float64 products
};

template <typename T, int DT, bool kFullD, typename Rows>
__global__ void __launch_bounds__(ATT_THREADS, sizeof(T) == 2 ? BWD_BF16_BLOCKS : 1)
    attention_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  constexpr int S = tile_row<T, DT>();
  constexpr int TILE = ATT_KEYS * S;
  constexpr int DS = DT / 8;  // 8-column slices of dQ
  constexpr bool kSharedA = bwd_shared_a<DT>();
  T* ks = reinterpret_cast<T*>(bwd_smem);  // [2 stages][64 keys][S]
  T* vs = ks + 2 * TILE;
  T* qs = vs + 2 * TILE;                    // DT = 128: [64 rows][S] Q, then dO
  using Ops = typename BwdMma<T, DT>::type;

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
  const double scale2d = static_cast<double>(p.scale) * LOG2E_D;

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

  BwdRow rs[2];
  Ops qa, da;
  {
    const T* q = static_cast<const T*>(p.q);
    const T* o = static_cast<const T*>(p.o);
    const T* dout = static_cast<const T*>(p.dout);
    const T* qrow[2];
    const T* drow[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = w0 + g + 8 * half;
      BwdRow& r = rs[half];
      r.in_range = i < nrows;
      const int n = rows.query(i);
      const int h = r.in_range ? rows.head(i) : 0;
      r.nb = n + p.offset;
      r.lim = p.causal ? min(key_len, max(r.nb + 1, 0)) : key_len;
      r.lo2 = p.slopes[h] * LOG2E;
      r.hi2 = p.slopes[p.H + h] * LOG2E;
      if constexpr (sizeof(T) == 4) {
        r.lo2d = static_cast<double>(p.slopes[h]) * LOG2E_D;
        r.hi2d = static_cast<double>(p.slopes[p.H + h]) * LOG2E_D;
      }
      r.hseed = rows.hash_base(i) + seed;
      // delta over this thread's 8-column chunks of the row (columns
      // 8t + 32u), then over the quad
      float part = 0.f;
      if (r.in_range) {
        const size_t off = rows.q_offset(i) + 8 * t;
        float a[8], b[8];
#pragma unroll
        for (int u = 0; u < (DT + 31) / 32; ++u) {
          if (8 * t + 32 * u < D) {
            widen8(dout + off + 32 * u, a);
            widen8(o + off + 32 * u, b);
#pragma unroll
            for (int e = 0; e < 8; ++e) part = fmaf(a[e], b[e], part);
          }
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      r.delta = part;
      r.lse2 = r.in_range ? p.lse[rows.lse_index(i)] * LOG2E : INFINITY;
      if constexpr (sizeof(T) == 4) {
        r.lse2d = r.in_range ? static_cast<double>(p.lse[rows.lse_index(i)]) * LOG2E_D
                             : static_cast<double>(INFINITY);
      }
      if (r.in_range && t == 0) p.delta[rows.lse_index(i)] = part;
      const bool used = r.in_range && warp_kend > 0;
      qrow[half] = used ? q + rows.q_offset(i) : nullptr;
      drow[half] = used ? dout + rows.q_offset(i) : nullptr;
    }
    if constexpr (kSharedA) {
      // the block's Q and dO rows, staged with the first K/V tile
      const bool any = block_kend > 0;
      stage_rows<T, DT>(qs, q, [&](int i) {
        return any && i < nrows ? q + rows.q_offset(i) : nullptr; }, D);
      stage_rows<T, DT>(qs + ATT_ROWS * S, dout, [&](int i) {
        return any && i < nrows ? dout + rows.q_offset(i) : nullptr; }, D);
      qa.bind(qs + w0 * S, lane);
      da.bind(qs + (ATT_ROWS + w0) * S, lane);
    } else {
      qa.load_q(qrow[0], qrow[1], t, D);
      da.load_q(drow[0], drow[1], t, D);
    }
  }

  float dq[DS][4];
#pragma unroll
  for (int d = 0; d < DS; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  float dsl[2][2] = {};  // [half][lower, upper]: sum of ds * -|c - c*|
  const float one[2] = {1.f, 1.f};

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
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
      qa.qk(s, ks + stage * TILE, lane);
      da.qk(dp, vs + stage * TILE, lane);

      // every key valid for every row, and all on one side of the diagonal
      const bool lower = c0 + ATT_KEYS - 1 <= wn_min;
      const bool upper = !p.causal && c0 > wn_max;
      const bool full = c0 + ATT_KEYS <= key_len && (lower || upper);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const BwdRow& r = rs[half];
        // element (j, e) is key c = c0 + 2t + 8j + e at distance d0 + 8j + e,
        // a0 + 8j + e from the row's nearest valid key c*
        const int cb = c0 + 2 * t;
        const float d0 = static_cast<float>(cb - r.nb);  // c - n - offset
        const float a0 = static_cast<float>(cb - min(max(r.nb, 0), max(r.lim - 1, 0)));
        const float sl = lower ? r.lo2 : -r.hi2;
        const uint32_t u0 = (r.hseed + static_cast<uint32_t>(cb)) * KEEP_MUL;
        float lo_acc = 0.f, hi_acc = 0.f;  // ds * (c - c*) by triangle
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dist = d0 + static_cast<float>(8 * j + e);  // exact
            float pr;
            if constexpr (sizeof(T) == 4) {  // the logit less lse in float64
              const double xd = fma(static_cast<double>(s[j][2 * half + e]), scale2d,
                                    (dist <= 0.f ? r.lo2d : -r.hi2d) * dist) - r.lse2d;
              pr = full || cb + 8 * j + e < r.lim ? fast_exp2(static_cast<float>(xd)) : 0.f;
            } else {
              float x;
              if (full) {
                x = fmaf(s[j][2 * half + e], scale2, sl * dist);
              } else {
                const float slope = dist <= 0.f ? r.lo2 : -r.hi2;
                x = cb + 8 * j + e < r.lim ? fmaf(s[j][2 * half + e], scale2, slope * dist)
                                           : ATT_NEG_INF;
              }
              pr = fast_exp2(x - r.lse2);
            }
            float dpv = dp[j][2 * half + e];
            if (drop) {  // dropped probabilities carry no gradient
              const uint32_t u = keep_mix(u0 + static_cast<uint32_t>(8 * j + e) * KEEP_MUL);
              dpv = u < thresh24 ? dpv * p.inv_keep : 0.f;
            }
            const float ds = pr * (dpv - r.delta);
            s[j][2 * half + e] = ds;
            const float arm = a0 + static_cast<float>(8 * j + e);  // exact
            if (full || dist <= 0.f) {
              lo_acc = fmaf(ds, arm, lo_acc);
            } else {
              hi_acc = fmaf(ds, arm, hi_acc);
            }
          }
        }
        // lower: -|c - c*| = c - c*; upper: -|c - c*| = c* - c
        if (full && !lower) {
          dsl[half][1] -= lo_acc;
        } else {
          dsl[half][0] += lo_acc;
          dsl[half][1] -= hi_acc;
        }
      }
      Ops::template pv<BWD_TERMS>(dq, s, one, ks + stage * TILE, lane);
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }
  cp_async_wait<0>();

  T* dqo = static_cast<T*>(p.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!rs[half].in_range) continue;
    T* row = dqo + rows.q_offset(w0 + g + 8 * half);
#pragma unroll
    for (int d = 0; d < DS; ++d) {
      if (8 * d < D) {
        Ops::store2(row + 8 * d + 2 * t, dq[d][2 * half] * p.scale,
                    dq[d][2 * half + 1] * p.scale);
      }
    }
  }

  // slope gradients: each row's sum over its quad, then over the block's
  // rows of each head in a fixed order, into the block's partials
  float* red = reinterpret_cast<float*>(bwd_smem);  // [2][64]; the tiles are done
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int tri = 0; tri < 2; ++tri) {
      float x = dsl[half][tri];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t == 0) red[tri * ATT_ROWS + w0 + g + 8 * half] = rs[half].in_range ? x : 0.f;
    }
  }
  __syncthreads();
  const int stride = rows.head_stride();
  const int lead = min(stride, nrows);  // rows 0 .. lead-1: one per head
  if (nrows > 0 && rows.query(0) < q_len && threadIdx.x < 2 * lead) {
    const int tri = threadIdx.x / lead, i0 = threadIdx.x % lead;
    float sum = 0.f;
    for (int i = i0; i < nrows; i += stride) sum += red[tri * ATT_ROWS + i];
    const int j = tri * p.H + rows.head(i0);  // (triangle, head)
    p.dslopes[2 * p.H + static_cast<size_t>(j) * p.slope_parts + rows.part()] = sum;
  }
}

// --------------------------------------------------------------- pass 2
template <typename T, int DT, bool kFullD, typename Keys>
__global__ void __launch_bounds__(ATT_THREADS, sizeof(T) == 2 ? BWD_BF16_BLOCKS : 1)
    attention_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  constexpr int S = tile_row<T, DT>();
  constexpr int TILE = ATT_KEYS * S;
  constexpr int DS = DT / 8;  // 8-column slices of dK and dV
  constexpr bool kSharedA = bwd_shared_a<DT>();
  constexpr int PART = dkv_part<T, DT>();  // rows a warp takes at once
  constexpr int SL = PART / 8;             // 8-row slices of a part
  T* qs = reinterpret_cast<T*>(bwd_smem);  // [2 stages][64 rows][S]
  T* gs = qs + 2 * TILE;                   // dO rows, the same
  float* ls = reinterpret_cast<float*>(gs + 2 * TILE);  // [2 stages][64] lse
  float* dl = ls + 2 * ATT_KEYS;                        // [2 stages][64] delta
  T* kvs = reinterpret_cast<T*>(dl + 2 * ATT_KEYS);     // DT = 128: [64 keys][S] K, then V
  using Ops = typename BwdMma<T, DT>::type;

  const int D = kFullD ? DT : p.D;  // the head dim
  const Keys keys(p, D);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int key_len = max(min(p.key_lens[keys.b], p.M), 0);
  const int q_len = min(p.q_lens[keys.b], p.N);
  const int c0 = blockIdx.x * ATT_ROWS;
  const int cw = c0 + 16 * warp;  // the warp's first key
  const bool drop = p.thresh < 256;
  const uint32_t thresh24 = static_cast<uint32_t>(p.thresh) << 24;
  const uint32_t seed = static_cast<uint32_t>(p.seed[0]) + p.seed_shift;
  const float scale2 = p.scale * LOG2E;

  // the rows this block's keys need: queries [n_start, q_len) of each head
  // it walks, in tiles of 64; this split takes items [it0, it1)
  const int n_start = p.causal ? max(c0 - p.offset, 0) : 0;
  const int ntq = c0 < key_len && q_len > n_start ? (q_len - n_start + ATT_KEYS - 1) / ATT_KEYS
                                                  : 0;
  const int h_lo = keys.head_lo();
  const int items = (keys.head_hi() - h_lo) * ntq;
  const int it0 = static_cast<int>(static_cast<long long>(items) * keys.split() / p.splits);
  const int it1 = static_cast<int>(static_cast<long long>(items) * (keys.split() + 1) / p.splits);

  Ops ka, va;  // the warp's 16 keys
  {
    const T* k = static_cast<const T*>(p.k) + keys.kv_offset();
    const T* v = static_cast<const T*>(p.v) + keys.kv_offset();
    if constexpr (kSharedA) {
      // the block's K and V rows, staged with the first row tile
      const bool any = it1 > it0;
      stage_rows<T, DT>(kvs, k, [&](int i) {
        return any && c0 + i < p.M ? k + (c0 + i) * keys.kv_stride() : nullptr; }, D);
      stage_rows<T, DT>(kvs + ATT_ROWS * S, v, [&](int i) {
        return any && c0 + i < p.M ? v + (c0 + i) * keys.kv_stride() : nullptr; }, D);
      ka.bind(kvs + 16 * warp * S, lane);
      va.bind(kvs + (ATT_ROWS + 16 * warp) * S, lane);
    } else {
      const T* krow[2];
      const T* vrow[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = cw + g + 8 * half;
        const bool used = c < p.M && cw < key_len && it1 > it0;
        krow[half] = used ? k + c * keys.kv_stride() : nullptr;
        vrow[half] = used ? v + c * keys.kv_stride() : nullptr;
      }
      ka.load_q(krow[0], krow[1], t, D);
      va.load_q(vrow[0], vrow[1], t, D);
    }
  }

  float dk[DS][4], dv[DS][4];
#pragma unroll
  for (int d = 0; d < DS; ++d) {
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
    dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
  }
  const float one[2] = {1.f, 1.f};

  // Q and dO rows n0 .. n0 + 63 of head h into a stage, lse and delta with
  // them; rows past q_len zero-filled (and masked below)
  const T* qb = static_cast<const T*>(p.q);
  const T* db = static_cast<const T*>(p.dout);
  const size_t qstride = keys.q_stride();
  constexpr int CHUNKS = DT * static_cast<int>(sizeof(T)) / 16;  // per tile row
  constexpr int PER = 16 / static_cast<int>(sizeof(T));         // elements
  auto load_tile = [&](int item, int stage) {
    const int h = h_lo + item / ntq;
    const int n0 = n_start + (item % ntq) * ATT_KEYS;
    const size_t base = keys.q_offset(n0, h);
#pragma unroll
    for (int u = 0; u < ATT_KEYS * CHUNKS / ATT_THREADS; ++u) {
      const int x = threadIdx.x + u * ATT_THREADS;
      const int j = x / CHUNKS, ch = x % CHUNKS;
      const bool ok = n0 + j < q_len && ch * PER < D;
      const size_t src = ok ? base + j * qstride + ch * PER : 0;
      const int dst = stage * TILE + j * S + ch * PER;
      cp_async16(qs + dst, qb + src, ok);
      cp_async16(gs + dst, db + src, ok);
    }
    const int j = threadIdx.x % ATT_KEYS;
    const bool ok = n0 + j < q_len;
    const size_t src = ok ? keys.lse_index(n0, h) + j * keys.lse_stride() : 0;
    if (threadIdx.x < ATT_KEYS) {
      cp_async4(ls + stage * ATT_KEYS + j, p.lse + src, ok);
    } else {
      cp_async4(dl + stage * ATT_KEYS + j, p.delta + src, ok);
    }
  };

  const uint32_t hstep = keys.hash_stride() * KEEP_MUL;  // the hash's step per row
  if (it1 > it0) load_tile(it0, 0);
  cp_async_commit();
  for (int it = it0; it < it1; ++it) {
    const int stage = (it - it0) & 1;
    if (it + 1 < it1) load_tile(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int h = h_lo + it / ntq;
    const float lo2 = p.slopes[h] * LOG2E;
    const float hi2 = p.slopes[p.H + h] * LOG2E;
    const uint32_t hrow = keys.hash_base(n_start + (it % ntq) * ATT_KEYS, h) + seed;
#pragma unroll
    for (int hr = 0; hr < ATT_KEYS / PART; ++hr) {
      const int n0 = n_start + (it % ntq) * ATT_KEYS + PART * hr;  // the part's first row
      const int nb0 = n0 + p.offset;
      // the warp's keys: none valid, no valid row, or (causal) all past
      // every row's diagonal
      if (cw >= key_len || n0 >= q_len || (p.causal && cw > nb0 + PART - 1)) continue;
      const T* qh = qs + stage * TILE + PART * hr * S;
      const T* gh = gs + stage * TILE + PART * hr * S;
      float s[SL][4], dp[SL][4];
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
      ka.template qk<SL>(s, qh, lane);   // S^T: keys x rows
      va.template qk<SL>(dp, gh, lane);  // dP^T

      // every pair valid, and all on one side of the diagonal
      const bool lower = cw + 15 <= nb0;
      const bool upper = !p.causal && cw > nb0 + PART - 1;
      const bool full = cw + 16 <= key_len && n0 + PART <= q_len && (lower || upper);
      const float sl = lower ? lo2 : -hi2;
      const float* lst = ls + stage * ATT_KEYS + PART * hr + 2 * t;
      const float* dlt = dl + stage * ATT_KEYS + PART * hr + 2 * t;
      // element (j, e) of key half k is key c = cw + g + 8k and row
      // n = n0 + 2t + 8j + e, at distance d0 + 8k - 8j - e
      const int cg = cw + g;
      const float d0 = static_cast<float>(cg - nb0 - 2 * t);  // c - n - offset, k = 0
      const uint32_t u0 = (hrow + static_cast<uint32_t>(cg)) * KEEP_MUL +
                          static_cast<uint32_t>(PART * hr + 2 * t) * hstep;
      const int qrem = q_len - n0 - 2 * t;  // rows 8j + e below this are valid
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(lst + 8 * j);  // rows 2t, 2t+1
        const float2 dj = *reinterpret_cast<const float2*>(dlt + 8 * j);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lse2 = (e ? lj.y : lj.x) * LOG2E;
          const float drow = e ? dj.y : dj.x;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float dist = d0 + static_cast<float>(8 * half - 8 * j - e);  // exact
            float x;
            if (full) {
              x = fmaf(s[j][2 * half + e], scale2, sl * dist);
            } else {
              const float slope = dist <= 0.f ? lo2 : -hi2;
              const bool ok = cg + 8 * half < key_len && 8 * j + e < qrem &&
                              (!p.causal || dist <= 0.f);
              x = ok ? fmaf(s[j][2 * half + e], scale2, slope * dist) : ATT_NEG_INF;
            }
            const float pr = fast_exp2(x - lse2);
            float pk = pr;
            float dpv = dp[j][2 * half + e];
            if (drop) {  // dropped probabilities carry no gradient
              const uint32_t u = keep_mix(u0 + static_cast<uint32_t>(8 * half) * KEEP_MUL +
                                          static_cast<uint32_t>(8 * j + e) * hstep);
              const float mf = u < thresh24 ? p.inv_keep : 0.f;
              pk = pr * mf;
              dpv *= mf;
            }
            s[j][2 * half + e] = pk;
            dp[j][2 * half + e] = pr * (dpv - drow);
          }
        }
      }
      Ops::template pv<BWD_TERMS, SL>(dv, s, one, gh, lane);   // P^T.dO
      Ops::template pv<BWD_TERMS, SL>(dk, dp, one, qh, lane);  // dS^T.Q
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }
  cp_async_wait<0>();

  // the warp's keys: dK and dV, or this split's f32 partial sums
  const size_t plane = static_cast<size_t>(p.B) * p.M * p.Hkv * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = cw + g + 8 * half;
    if (c >= p.M) continue;
    const size_t off = keys.kv_offset() + c * keys.kv_stride() + 2 * t;
    if (p.splits == 1) {
      T* dkr = static_cast<T*>(p.dk) + off;
      T* dvr = static_cast<T*>(p.dv) + off;
#pragma unroll
      for (int d = 0; d < DS; ++d) {
        if (8 * d < D) {
          Ops::store2(dkr + 8 * d, dk[d][2 * half] * p.scale, dk[d][2 * half + 1] * p.scale);
          Ops::store2(dvr + 8 * d, dv[d][2 * half], dv[d][2 * half + 1]);
        }
      }
    } else {
      float* wk = p.work + 2 * static_cast<size_t>(keys.split()) * plane + off;
      float* wv = wk + plane;
#pragma unroll
      for (int d = 0; d < DS; ++d) {
        if (8 * d < D) {
          *reinterpret_cast<float2*>(wk + 8 * d) =
              make_float2(dk[d][2 * half] * p.scale, dk[d][2 * half + 1] * p.scale);
          *reinterpret_cast<float2*>(wv + 8 * d) =
              make_float2(dv[d][2 * half], dv[d][2 * half + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------- pass 3
// splits > 1: dK and dV as the sums of the splits' partials, in order
template <typename T>
__global__ void dkv_sum_kernel(const float* __restrict__ work, T* __restrict__ dk,
                               T* __restrict__ dv, size_t plane, int splits) {
  const size_t i = 4 * (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= plane) return;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < splits; ++s) {
    const float4 a = *reinterpret_cast<const float4*>(work + 2 * s * plane + i);
    const float4 b = *reinterpret_cast<const float4*>(work + (2 * s + 1) * plane + i);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += b.x; sv.y += b.y; sv.z += b.z; sv.w += b.w;
  }
  store1(dk + i, sk.x); store1(dk + i + 1, sk.y); store1(dk + i + 2, sk.z);
  store1(dk + i + 3, sk.w);
  store1(dv + i, sv.x); store1(dv + i + 1, sv.y); store1(dv + i + 2, sv.z);
  store1(dv + i + 3, sv.w);
}

// dslopes[j] as the sum of (triangle, head) j's slope_parts partials (from
// dslopes + 2H, one row each), in a fixed order: block j's threads strided
// over the row, each warp by the shuffle tree, then the warps in order.
__global__ void slope_sum_kernel(float* __restrict__ dslopes, int n, int parts) {
  extern __shared__ __align__(16) unsigned char sum_smem[];
  float* warps = reinterpret_cast<float*>(sum_smem);  // [ATT_THREADS / 32]
  const float* row = dslopes + n + static_cast<size_t>(blockIdx.x) * parts;
  float s = 0.f;
  for (int i = threadIdx.x; i < parts; i += ATT_THREADS) s += row[i];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < ATT_THREADS / 32; ++w) total += warps[w];
    dslopes[blockIdx.x] = total;
  }
}

// Launch the passes on `st`: grid1 the row-stationary blocks, then the
// slope sums, grid2 the key-stationary ones (y: splits, times H for
// per-head K/V). The shared memory limits are raised once per device, so
// the launches can be captured in a CUDA graph. Returns the first CUDA
// error.
template <typename T, int DT, bool kFullD, typename Rows, typename Keys>
cudaError_t launch_bwd_kernels(dim3 grid1, dim3 grid2, const BwdParams& p, cudaStream_t st) {
  constexpr auto dq_kernel = attention_dq_kernel<T, DT, kFullD, Rows>;
  constexpr auto dkv_kernel = attention_dkv_kernel<T, DT, kFullD, Keys>;
  constexpr int dq_bytes = dq_smem_bytes<T, DT>(), dkv_bytes = dkv_smem_bytes<T, DT>();
  cudaError_t err = raise_smem_once<dq_kernel>(dq_bytes);
  if (err == cudaSuccess) err = raise_smem_once<dkv_kernel>(dkv_bytes);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid1, ATT_THREADS, dq_bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  slope_sum_kernel<<<2 * p.H, ATT_THREADS, ATT_THREADS / 32 * sizeof(float), st>>>(
      p.dslopes, 2 * p.H, p.slope_parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<grid2, ATT_THREADS, dkv_bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const size_t plane = static_cast<size_t>(p.B) * p.M * p.Hkv * p.D;
  const unsigned blocks = static_cast<unsigned>((plane / 4 + 255) / 256);
  dkv_sum_kernel<T><<<blocks, 256, 0, st>>>(p.work, static_cast<T*>(p.dk),
                                            static_cast<T*>(p.dv), plane, p.splits);
  return cudaGetLastError();
}

// The instantiations for p.D: the full-width ones at D == DT.
template <typename T, int DT, typename Rows, typename Keys>
cudaError_t launch_attention_bwd(dim3 grid1, dim3 grid2, const BwdParams& p, cudaStream_t st) {
  return p.D == DT ? launch_bwd_kernels<T, DT, true, Rows, Keys>(grid1, grid2, p, st)
                   : launch_bwd_kernels<T, DT, false, Rows, Keys>(grid1, grid2, p, st);
}

}  // namespace
