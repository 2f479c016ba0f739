// The tensor-core building blocks of the attention tile cores, forward
// (attention_fwd.cuh: K1, K5a) and backward (attention_bwd.cuh: K2, K5b):
// PTX wrappers for cp.async, ldmatrix and mma.sync, the operand splits, and
// the per-dtype product structs that both cores run every product through.
//
// A warp owns a 16-row tile. Its A operand (16 rows x DT dims, DT the tile
// width of attention_common.cuh) sits in registers as mma fragments, or,
// where a core holds too many other registers (the backward at DT = 128),
// in shared memory, read as fragments at each reduction step; the B operand
// (kSlices * 8 rows x DT dims) is a tile in shared memory, rows
// tile_row<T, DT>() elements apart (padded by one 16-byte chunk, so
// ldmatrix and the f32 reads are free of bank conflicts at every DT). Two
// products cover every product of both cores:
//   qk: s (16 x 8 kSlices) = A . B^T   (the logits Q.K^T; dO.V^T; K.Q^T; V.dO^T)
//   pv: o (16 x DT) += P . B           (P.V; dS.K; P^T.dO; dS^T.Q)
// with P in qk's accumulator layout: element (row lane/4 or lane/4 + 8,
// column 2*(lane%4) + {0,1}) of each 8-column slice. qk reduces over the
// tile width, DT/16 k-steps in bf16 and DT/8 in 3xTF32; pv writes DT/8
// 8-column slices. Columns past the head dim are zero in A and B.
//
// Precision, per input type:
// - bf16: qk is mma.m16n8k16 on the bf16 inputs with f32 accumulation
//   (exact products). pv takes P (f32) split as p_hi + p_lo, both bf16, in
//   two MMAs (P kept to ~2^-17); one term rounds P to bf16.
// - f32: both products are 3xTF32 mma.m16n8k8 (x = hi + lo, hi and lo
//   rounded to tf32; hi.hi + hi.lo + lo.hi), about f32 accuracy; plain TF32
//   would leave ~1e-3. The m16n8k8 accumulator holds columns (2t, 2t+1) of
//   a thread's rows where its A fragment wants (t, t+4), so pv reads each
//   8-column slice of B in the order 0,2,4,6,1,3,5,7: the thread's P
//   registers go in unshuffled and its B rows are read as 2t and 2t+1. A
//   sum over the slice does not see the order.
//
// The tensor cores' accumulator adds do not round to nearest: accumulated
// in one fragment over a long loop, a product drifts toward zero. So pv
// sums each tile in fresh fragments and adds them on the CUDA cores
// (rescale_add), which round to nearest.
//
// Every includer is its own translation unit, so the helpers sit in an
// anonymous namespace.

#pragma once

#include "attention_common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Elements per padded shared-memory row of a DT-wide tile.
template <typename T, int DT>
__host__ __device__ constexpr int tile_row() {
  return DT + 16 / static_cast<int>(sizeof(T));
}

// 8-column slices of a DT-wide output that pv sums together in fresh
// fragments before adding them on the CUDA cores.
template <int DT>
__host__ __device__ constexpr int pv_group() {
  return DT >= 32 ? 4 : DT / 8;
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

// 4 bytes global -> shared, asynchronous; zero-fill where !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
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

// o[d0 + i] = o[d0 + i] * alpha + t[i] for the G accumulators of one group
// of 8-column slices, alpha[0] on row g (registers 0, 1), alpha[1] on row
// g + 8: each tile's product, summed apart, added on the CUDA cores.
template <int DS, int G>
__device__ __forceinline__ void rescale_add(float (&o)[DS][4], int d0, const float (&t)[G][4],
                                            const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[d0 + i][r] = fmaf(o[d0 + i][r], alpha[r / 2], t[i][r]);
  }
}

// ------------------------------------------------- products, per input type
// The product structs hold a warp's A operand and run the two products on
// one tile:
//   qk: s[j] (columns 8j..8j+7) = A . B^T for the tile's 8 * kSlices rows;
//   pv: o[d] (dims 8d..8d+7) = o[d] * alpha + P . B, P in s's layout, in
//       kTerms bf16 terms (bf16 only: 2 is p_hi + p_lo, 1 rounds P).
// `bs` points at the first row taken. The loops put the reduction step
// outermost, so consecutive MMAs go to different accumulators.
//
// The A operand comes in one of two ways (kShared):
// - resident: load_q reads the warp's rows g and g + 8 from device memory
//   into fragments once (null: a row past the operand, zeros; columns past
//   D, zeros);
// - shared: bind names the warp's 16 rows of a tile the core has staged in
//   shared memory (zero past the operand and past D), and qk reads each
//   k-step's fragment there as it goes, which frees the registers a
//   resident operand holds.

// bf16: mma.m16n8k16.
template <int DT, bool kShared>
struct MmaBf16 {
  using T = __nv_bfloat16;
  static constexpr int S = tile_row<T, DT>();
  static constexpr int KS = DT / 16;  // k-steps of 16 dims
  static constexpr int DS = DT / 8;   // 8-column output slices
  uint32_t qa[kShared ? 1 : KS][4];
  const T* as = nullptr;  // shared: this lane's ldmatrix row of the A tile

  // rows g and g + 8 of the warp's tile (null: a row past the operand)
  __device__ void load_q(const T* rg, const T* rg8, int t, int D) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d = 16 * kk + 2 * t;  // pairs (d, d + 1) lie on one side of D
      qa[kk][0] = rg && d < D ? *reinterpret_cast<const uint32_t*>(rg + d) : 0u;
      qa[kk][1] = rg8 && d < D ? *reinterpret_cast<const uint32_t*>(rg8 + d) : 0u;
      qa[kk][2] = rg && d + 8 < D ? *reinterpret_cast<const uint32_t*>(rg + d + 8) : 0u;
      qa[kk][3] = rg8 && d + 8 < D ? *reinterpret_cast<const uint32_t*>(rg8 + d + 8) : 0u;
    }
  }

  // the warp's 16 rows of a staged tile, S elements apart
  __device__ void bind(const T* rows, int lane) {
    as = rows + (lane % 16) * S + 8 * (lane / 16);
  }

  // k-step kk's A fragment
  __device__ void frag(int kk, uint32_t (&a)[4]) const {
    if constexpr (kShared) {
      ldmatrix_x4(a, as + 16 * kk);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qa[kk][r];
    }
  }

  // kSlices: the 8-column slices (B rows) taken, 8 for a whole tile
  template <int kSlices = 8>
  __device__ void qk(float (&s)[kSlices][4], const T* bs, int lane) const {
    if constexpr (DT == 16) {  // one k-step: B for two slices a load
      static_assert(kSlices % 2 == 0, "slices in pairs");
      uint32_t a[4];
      frag(0, a);
#pragma unroll
      for (int jp = 0; jp < kSlices / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, bs + (8 * (2 * jp + lane / 16) + lane % 8) * S + 8 * ((lane / 8) & 1));
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    } else {
#pragma unroll
      for (int h = 0; h < DT / 32; ++h) {  // dims 32h .. 32h + 31: k-steps 2h, 2h+1
        uint32_t b[kSlices][4];
#pragma unroll
        for (int j = 0; j < kSlices; ++j) {
          ldmatrix_x4(b[j], bs + (8 * j + lane % 8) * S + 32 * h + 8 * (lane / 8));
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t a[4];
          frag(2 * h + u, a);
#pragma unroll
          for (int j = 0; j < kSlices; ++j) mma_bf16(s[j], a, b[j][2 * u], b[j][2 * u + 1]);
        }
      }
    }
  }

  // P goes in as kTerms bf16 terms (split_bf16), the smaller first
  template <int kTerms, int kSlices = 8>
  __device__ static void pv(float (&o)[DS][4], const float (&p)[kSlices][4],
                            const float (&alpha)[2], const T* bs, int lane) {
    constexpr int K = kSlices / 2;  // k-steps of 16 columns
    constexpr int G = pv_group<DT>();
    uint32_t a[K][2][4];  // [columns 16j .. 16j + 15][hi, lo][A register]
#pragma unroll
    for (int j = 0; j < K; ++j) {
      split_bf16(p[2 * j][0], p[2 * j][1], a[j][0][0], a[j][1][0]);
      split_bf16(p[2 * j][2], p[2 * j][3], a[j][0][1], a[j][1][1]);
      split_bf16(p[2 * j + 1][0], p[2 * j + 1][1], a[j][0][2], a[j][1][2]);
      split_bf16(p[2 * j + 1][2], p[2 * j + 1][3], a[j][0][3], a[j][1][3]);
    }
#pragma unroll
    for (int dh = 0; dh < DS / G; ++dh) {  // dims 8G dh .. 8G dh + 8G - 1
      float t[G][4] = {};
#pragma unroll
      for (int j = 0; j < K; ++j) {
        uint32_t b[G / 2][4];
#pragma unroll
        for (int d2 = 0; d2 < G / 2; ++d2) {
          ldmatrix_x4_trans(b[d2], bs + (16 * j + 8 * ((lane / 8) & 1) + lane % 8) * S +
                                       8 * G * dh + 16 * d2 + 8 * (lane / 16));
        }
#pragma unroll
        for (int term = kTerms - 1; term >= 0; --term) {
#pragma unroll
          for (int d2 = 0; d2 < G / 2; ++d2) {
            mma_bf16(t[2 * d2], a[j][term], b[d2][0], b[d2][1]);
            mma_bf16(t[2 * d2 + 1], a[j][term], b[d2][2], b[d2][3]);
          }
        }
      }
      rescale_add(o, G * dh, t, alpha);
    }
  }

  __device__ static void store2(T* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
};

// f32 as 3xTF32. kPreSplit keeps a resident A operand as hi and lo (DT
// registers); otherwise it keeps the f32 values (DT/2) and splits them at
// each use, the same hi and lo, for a core that holds two A operands or a
// wide tile.
template <bool kPreSplit, int DT, bool kShared = false>
struct MmaTf32 {
  using T = float;
  static constexpr int S = tile_row<T, DT>();
  static constexpr int KS = DT / 8;  // k-steps of 8 dims
  static constexpr int DS = DT / 8;  // 8-column output slices
  static_assert(!(kShared && kPreSplit), "a shared A operand splits at each use");
  uint32_t a0[kShared ? 1 : KS][4];                  // hi, or the f32 bits
  uint32_t a1[kPreSplit ? KS : 1][4];                // lo (pre-split only)
  const T* as = nullptr;  // shared: this lane's element (row g, column t)

  __device__ void load_q(const T* rg, const T* rg8, int t, int D) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d = 8 * kk + t;
      const float x[4] = {rg && d < D ? rg[d] : 0.f, rg8 && d < D ? rg8[d] : 0.f,
                          rg && d + 4 < D ? rg[d + 4] : 0.f, rg8 && d + 4 < D ? rg8[d + 4] : 0.f};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (kPreSplit) {
          tf32_split(x[r], a0[kk][r], a1[kk][r]);
        } else {
          a0[kk][r] = __float_as_uint(x[r]);
        }
      }
    }
  }

  // the warp's 16 rows of a staged tile, S elements apart
  __device__ void bind(const T* rows, int lane) { as = rows + (lane / 4) * S + lane % 4; }

  // k-step kk's A fragment as hi and lo
  __device__ void split(int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
    if constexpr (kShared) {
      const float x[4] = {as[8 * kk], as[8 * S + 8 * kk], as[8 * kk + 4], as[8 * S + 8 * kk + 4]};
#pragma unroll
      for (int r = 0; r < 4; ++r) tf32_split(x[r], hi[r], lo[r]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (kPreSplit) {
          hi[r] = a0[kk][r];
          lo[r] = a1[kk][r];
        } else {
          tf32_split(__uint_as_float(a0[kk][r]), hi[r], lo[r]);
        }
      }
    }
  }

  // three passes of 3xTF32 over four columns at a time
  template <int kSlices = 8>
  __device__ void qk(float (&s)[kSlices][4], const T* bs, int lane) const {
    static_assert(kSlices % 4 == 0, "slices in fours");
#pragma unroll
    for (int h = 0; h < DT / 16; ++h) {  // dims 16h .. 16h + 15: k-steps 2h, 2h+1
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) split(2 * h + u, ah[u], al[u]);
#pragma unroll
      for (int jg = 0; jg < kSlices; jg += 4) {
        uint32_t b[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ldmatrix_x4(b[j], bs + (8 * (jg + j) + lane % 8) * S + 16 * h + 4 * (lane / 8));
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tf32_split(__uint_as_float(b[j][2 * u]), bh[j][0], bl[j][0]);
            tf32_split(__uint_as_float(b[j][2 * u + 1]), bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(s[jg + j], al[u], bh[j][0], bh[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(s[jg + j], ah[u], bl[j][0], bl[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32(s[jg + j], ah[u], bh[j][0], bh[j][1]);
        }
      }
    }
  }

  template <int kTerms, int kSlices = 8>
  __device__ static void pv(float (&o)[DS][4], const float (&p)[kSlices][4],
                            const float (&alpha)[2], const T* bs, int lane) {
    constexpr int G = pv_group<DT>();
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int dh = 0; dh < DS / G; ++dh) {  // dims 8G dh .. 8G dh + 8G - 1
      float acc[G][4] = {};
#pragma unroll
      for (int j = 0; j < kSlices; ++j) {  // columns 8j .. 8j + 7, read as 8j + {2t, 2t+1}
        uint32_t ah[4], al[4];
        tf32_split(p[j][0], ah[0], al[0]);  // row g,     column 2t   -> A column t
        tf32_split(p[j][2], ah[1], al[1]);  // row g + 8, column 2t
        tf32_split(p[j][1], ah[2], al[2]);  // row g,     column 2t+1 -> A column t + 4
        tf32_split(p[j][3], ah[3], al[3]);  // row g + 8, column 2t+1
        const T* v0 = bs + (8 * j + 2 * t) * S + 8 * G * dh + g;
        uint32_t bh[G][2], bl[G][2];
#pragma unroll
        for (int d = 0; d < G; ++d) {
          tf32_split(v0[8 * d], bh[d][0], bl[d][0]);
          tf32_split(v0[S + 8 * d], bh[d][1], bl[d][1]);
        }
#pragma unroll
        for (int d = 0; d < G; ++d) mma_tf32(acc[d], al, bh[d][0], bh[d][1]);
#pragma unroll
        for (int d = 0; d < G; ++d) mma_tf32(acc[d], ah, bl[d][0], bl[d][1]);
#pragma unroll
        for (int d = 0; d < G; ++d) mma_tf32(acc[d], ah, bh[d][0], bh[d][1]);
      }
      rescale_add(o, G * dh, acc, alpha);
    }
  }

  __device__ static void store2(T* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

// The forward's A operand (Q), resident: pre-split in f32 up to DT = 64; at
// DT = 128 the pre-split Q alone would be 128 registers a thread, so the
// f32 values are kept and split at each use.
template <typename T, int DT>
struct FwdMma {
  using type = MmaBf16<DT, false>;
};
template <int DT>
struct FwdMma<float, DT> {
  using type = MmaTf32<(DT <= 64), DT>;
};

// Raise a kernel's dynamic shared memory limit above the 48 KB default,
// once per device (a repeated raise is harmless, so the flags need no
// lock), so that its launches make no other runtime call and can be
// captured in a CUDA graph. Returns the CUDA error of the attribute call.
template <auto kKernel>
cudaError_t raise_smem_once(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static unsigned long long raised = 0;  // bit d: device d's limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !((raised >> dev) & 1ull))) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < 64) raised |= 1ull << dev;
  }
  return err;
}

}  // namespace
