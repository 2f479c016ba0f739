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
};

// Dynamic shared memory of one block: two stages of K and of V.
template <typename T>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 4 * ATT_KEYS * tile_row<T>() * static_cast<int>(sizeof(T));
}

// The same for the entry points' dtype code (0 f32, 1 bf16), 0 for another.
inline int fwd_smem_bytes_of(int dtype) {
  return dtype == 0 ? fwd_smem_bytes<float>() : dtype == 1 ? fwd_smem_bytes<__nv_bfloat16>() : 0;
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
// HeadRows). bf16 blocks are held to Rows::kBf16Blocks an SM (170 registers a thread
// for 3, 128 for 4); f32 blocks take what they need.
template <typename T, typename Rows>
__global__ void __launch_bounds__(ATT_THREADS, sizeof(T) == 2 ? Rows::kBf16Blocks : 1)
    attention_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  constexpr int S = tile_row<T>();
  constexpr int TILE = ATT_KEYS * S;
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
  const int block_kend = needed(0, ATT_ROWS - 1);
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
      r.m = ATT_NEG_INF;
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
  constexpr int CHUNKS = ATT_D * static_cast<int>(sizeof(T)) / 16;  // per row
  constexpr int PER = 16 / static_cast<int>(sizeof(T));            // elements
  auto load_tile = [&](int c0, int stage) {
#pragma unroll
    for (int u = 0; u < ATT_KEYS * CHUNKS / ATT_THREADS; ++u) {
      const int x = threadIdx.x + u * ATT_THREADS;
      const int j = x / CHUNKS, ch = x % CHUNKS;
      const int c = c0 + j;
      const bool ok = c < block_kend;
      const size_t src = (ok ? c : 0) * kstride + ch * PER;
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
      Mma<T>::template pv<FWD_P_TERMS>(o, s, alpha, vs + stage * TILE, lane);
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

// Launch one instantiation on `st` with its dynamic shared memory (the
// limit raised once per device, so the launch can be captured in a CUDA
// graph). Returns the CUDA error of the attribute call or the launch.
template <typename T, typename Rows>
cudaError_t launch_attention_fwd(dim3 grid, const FwdParams& p, cudaStream_t st) {
  constexpr auto kernel = attention_fwd_kernel<T, Rows>;
  constexpr int bytes = fwd_smem_bytes<T>();
  const cudaError_t err = raise_smem_once<kernel>(bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ATT_THREADS, bytes, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
