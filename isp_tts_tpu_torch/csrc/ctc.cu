// Banded ordered-label CTC: -log Z of the label sequence [1..text_len] over
// a (mel x (text+1)) log-probability map, and its gradient.
//
// Replaces the TPU kernels isp_tts_tpu/ops/ctc_pallas.py:_fwd_kernel
// (wrapper _run_fwd) and _bwd_kernel (wrapper _ctc_bwd). With distinct,
// ordered labels the CTC lattice collapses to two state vectors of width
// W = T + 1 (blank after j labels; emitting label j+1), streamed over frames:
//   c_j       = lse(blank_j, label_{j-1})
//   blank_j  <- c_j + lp[t, 0]
//   label_j  <- lse(label_j, c_j) + lp[t, j+1]      (lp[t, W] = NEG)
// with NEG = -1e30, lse(a, b) = log(e^a + e^b), frames at or past mel_len
// frozen, and log Z = lse(blank_L, label_{L-1}) for L = clip(text_len, 1, T).
// The forward stores every frame's alphas. The backward runs the beta
// recursion from the accept states,
//   blank_j  <- lse(u_j, v_j),  label_j <- lse(v_j, u_{j+1}, v_{j+1})
//   (u_j = blank_j + lp[t, 0], v_j = label_j + lp[t, j+1]),
// and writes
//   dlp[t, 0]   = -g * sum_j exp(min(ab_t[j] + bb_t[j] - log Z, 0))
//   dlp[t, j+1] = -g * exp(min(al_t[j] + bl_t[j] - log Z, 0))
// (the clip at 0 keeps an infeasible sample, log Z ~ NEG, from giving
// inf * 0), and zero past mel_len. The zero_infinity gate is the loss's.
//
// Precision: alpha and beta grow to ~mel_len * |log p| (thousands at
// mel 1024), and in f32 each step's rounding at that magnitude (~1e-4)
// would reach the gradient through exp(alpha + beta - log Z) as a relative
// error of 1e-3. So the state vectors, the stored alphas and log Z are
// f64; the transcendental part of each lse, log(sum e^(x - max)) (the
// differences are at most 0, the sum in [1, 3]), and the occupancy exp are
// f32 on arguments of small magnitude, by ex2/lg2.approx.
//
// What bounds it on an H100: a chain of mel_len dependent frames, each run
// by one warp's in-order instruction stream; the bytes (the map read twice,
// the alphas written once and read once, the gradient written once) take
// ~2-3 us at the training shape. So the design (dp_common.cuh) keeps a
// frame's instructions few: one column a lane (a warp per 32 columns: two
// warps at the training shape, W = 49, on two of the SM's schedulers), the
// state in registers, the left (right) neighbour by one shuffle and across
// warps through shared memory with one barrier a frame; the nested lse of
// the recursion as one 3-way lse; the map (and the backward's alphas)
// staged by cp.async D - 1 frames ahead; running pointers; fire-and-forget
// stores. The backward's blank occupancy is summed over the lanes once per
// CHUNK frames (each lane's value to shared memory a frame, then one
// transposed sum), not by a shuffle reduction a frame. Launch: one block per
// sequence, grid B.
//
// Plain C interface for ctypes; each launch goes on the caller's stream and
// its function returns cudaGetLastError().

#include <math.h>
#include <stddef.h>

#include "dp_common.cuh"

namespace {

constexpr double NEG = -1e30;
constexpr float LOG2E = 1.4426950408889634f;
constexpr double LN2 = 0.6931471805599453;
// frames a blank-occupancy sum covers
constexpr int CHUNK = 16;

__device__ __forceinline__ double dmax(double a, double b) { return a > b ? a : b; }

// log(e^a + e^b) = max + log(1 + e^-|a - b|)
__device__ __forceinline__ double lse2(double a, double b) {
  const float d = static_cast<float>(fabs(a - b));
  return fma(static_cast<double>(fast_log2(1.f + fast_exp2(-LOG2E * d))), LN2, dmax(a, b));
}

// log(e^a + e^b + e^c)
__device__ __forceinline__ double lse3(double a, double b, double c) {
  const double m = dmax(dmax(a, b), c);
  const float s = fast_exp2(LOG2E * static_cast<float>(a - m))
                  + fast_exp2(LOG2E * static_cast<float>(b - m))
                  + fast_exp2(LOG2E * static_cast<float>(c - m));
  return fma(static_cast<double>(fast_log2(s)), LN2, m);
}

// frames in a lane's staging ring, by the row's warps (shared memory)
inline int ring_frames(int warps) { return warps <= 8 ? 16 : warps <= 16 ? 8 : 4; }

// The forward's staging: frame s's map into slot s % D of the lane's ring
// (lp[s, j+1]; lp[s, 0]), one commit group a frame, frames in order.
template <int D>
struct FwdStage {
  float* ring;
  const float* src;   // lp[s, j+1]
  const float* src0;  // lp[s, 0]
  int s, ml, W, lane;
  bool next;

  __device__ __forceinline__ void fetch() {
    float* slot = ring + (s & (D - 1)) * 64;
    cp_async4(slot + lane, src, next && s < ml);
    cp_async4(slot + 32 + lane, src0, s < ml);
    cp_async_commit();
    ++s;
    src += W;
    src0 += W;
  }
};

// Forward. Lane j (of the block) owns column j. Shared memory: each warp's
// ring of D frames x 2 x 32 floats, then the edge slots [2][nw] and the
// readout's two states.
template <int D>
__global__ void __launch_bounds__(1024) ctc_fwd_kernel(
    const float* __restrict__ lp, const int* __restrict__ text_lens,
    const int* __restrict__ mel_lens, double* __restrict__ ab, double* __restrict__ al,
    double* __restrict__ logz, float* __restrict__ neg_logp, int M, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const int ml = max(min(mel_lens[b], M), 0);
  double* edges = reinterpret_cast<double*>(smem + nw * D * 256);
  double* ends = edges + 2 * nw;
  const bool col = j < W;
  const bool next = j + 1 < W;
  const size_t base = static_cast<size_t>(b) * M * W;

  FwdStage<D> stage{reinterpret_cast<float*>(smem) + w * D * 64,
                    lp + base + (next ? j + 1 : 0), lp + base, 0, ml, W, lane, next};
  for (int s = 0; s < D - 1; ++s) stage.fetch();

  double blank = j == 0 ? 0.0 : NEG;
  double label = NEG;
  double* pab = ab + base + j;
  double* pal = al + base + j;
  for (int t = 0; t < ml; ++t) {
    double edge = NEG;  // label of the column left of this warp's first
    if (nw > 1) {
      if (lane == 31) edges[(t & 1) * nw + w] = label;
      __syncthreads();
      if (w > 0) edge = edges[(t & 1) * nw + w - 1];
    }
    cp_async_wait<D - 2>();  // frame t has landed
    stage.fetch();
    const float* slot = stage.ring + (t & (D - 1)) * 64;
    const double m = next ? static_cast<double>(slot[lane]) : NEG;  // map read
    const double lp0 = slot[32 + lane];
    double left = from_left(label, lane);
    if (lane == 0) left = edge;
    const double nb = lse2(blank, left) + lp0;
    const double nl = lse3(label, blank, left) + m;
    if (col) {
      *pab = nb;  // alpha store
      *pal = nl;  // alpha store
    }
    pab += W;
    pal += W;
    blank = nb;
    label = nl;
  }
  cp_async_wait<0>();

  const int L = min(max(text_lens[b], 1), W - 1);
  if (j == L) ends[0] = blank;
  if (j == L - 1) ends[1] = label;
  __syncthreads();
  if (threadIdx.x == 0) {
    const double z = lse2(ends[0], ends[1]);
    logz[b] = z;
    neg_logp[b] = static_cast<float>(-z);
  }
}

// The backward's staging: frame ml - 1 - s into slot s % D of the lane's
// ring: 3 x 32 floats (lp[t, j+1]; lp[t, 0]; lp[t, jn+1], the map of the
// next warp's first column jn), then 2 x 32 doubles (ab[t, j]; al[t, j]).
template <int D>
struct BwdStage {
  static constexpr int FRAME = 3 * 32 * 4 + 2 * 32 * 8;  // bytes a frame
  unsigned char* ring;
  const float *src, *src0, *srcn;
  const double *sab, *sal;
  int s, ml, W, lane;
  bool col, next, next_warp_next;

  __device__ __forceinline__ void fetch() {
    unsigned char* slot = ring + (s & (D - 1)) * FRAME;
    float* map = reinterpret_cast<float*>(slot);
    double* alpha = reinterpret_cast<double*>(slot + 3 * 32 * 4);
    const bool live = s < ml;
    cp_async4(map + lane, src, live && next);
    cp_async4(map + 32 + lane, src0, live);
    cp_async4(map + 64 + lane, srcn, live && next_warp_next);
    cp_async8(alpha + lane, sab, live && col);
    cp_async8(alpha + 32 + lane, sal, live && col);
    cp_async_commit();
    ++s;
    src -= W;
    src0 -= W;
    srcn -= W;
    sab -= W;
    sal -= W;
  }
};

// The warp's blank occupancies of up to CHUNK frames (part[f][lane]),
// summed over the lanes: lanes f and f + 16 get frame f's sum.
__device__ __forceinline__ float sum_lanes(const float* part, int lane) {
  const float* row = part + (lane & (CHUNK - 1)) * 33 + (lane >= CHUNK ? 16 : 0);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int l = 0; l < 16; l += 2) {
    s0 += row[l];
    s1 += row[l + 1];
  }
  const float s = s0 + s1;
  return s + __shfl_xor_sync(FULL_MASK, s, 16);
}

// Backward. Lane j (of the block) owns column j. Shared memory: each warp's
// ring (BwdStage); each warp's occupancy rows part[CHUNK][33]; the warps'
// chunk sums [2][nw][CHUNK]; the edge slots [2][nw][2] (blank, label).
template <int D>
__global__ void __launch_bounds__(1024) ctc_bwd_kernel(
    const float* __restrict__ lp, const double* __restrict__ ab,
    const double* __restrict__ al, const double* __restrict__ logz,
    const float* __restrict__ g, const int* __restrict__ text_lens,
    const int* __restrict__ mel_lens, float* __restrict__ dlp, int M, int W) {
  constexpr int FRAME = BwdStage<D>::FRAME;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const int ml = max(min(mel_lens[b], M), 0);
  const int L = min(max(text_lens[b], 1), W - 1);
  const double z = logz[b];
  const float gb = g[b];
  float* parts = reinterpret_cast<float*>(smem + static_cast<size_t>(nw) * D * FRAME);
  float* part = parts + w * CHUNK * 33;
  float* wsum = parts + nw * CHUNK * 33;
  double* edges = reinterpret_cast<double*>(wsum + 2 * nw * CHUNK);
  const bool col = j < W;
  const bool next = j + 1 < W;
  const int jn = 32 * (w + 1);  // the next warp's first column
  const bool next_warp = w + 1 < nw;
  const bool next_warp_next = jn + 1 < W;
  const size_t base = static_cast<size_t>(b) * M * W;
  const size_t last = base + static_cast<size_t>(max(ml - 1, 0)) * W;  // frame ml - 1

  BwdStage<D> stage{smem + static_cast<size_t>(w) * D * FRAME,
                    lp + last + (next ? j + 1 : 0), lp + last,
                    lp + last + (next_warp_next ? jn + 1 : 0), ab + last + (col ? j : 0),
                    al + last + (col ? j : 0), 0, ml, W, lane, col, next, next_warp_next};
  for (int s = 0; s < D - 1; ++s) stage.fetch();

  double bb = j == L ? 0.0 : NEG;
  double bl = j == L - 1 ? 0.0 : NEG;
  float* grad = dlp + last + j + 1;  // dlp[t, j + 1], t = ml - 1 - n
  float* const grad0 = dlp + last;   // dlp[ml - 1, 0]
  for (int n = 0; n < ml; ++n) {
    double ebb = NEG, ebl = NEG;  // beta of the next warp's first column
    if (nw > 1) {
      if (lane == 0) {
        edges[((n & 1) * nw + w) * 2] = bb;
        edges[((n & 1) * nw + w) * 2 + 1] = bl;
      }
      __syncthreads();
      if (next_warp) {
        ebb = edges[((n & 1) * nw + w + 1) * 2];
        ebl = edges[((n & 1) * nw + w + 1) * 2 + 1];
      }
      if (w == 0 && n > 0 && n % CHUNK == 0 && lane < CHUNK) {
        // the previous chunk's blank occupancy, summed over the warps
        const float* ws = wsum + ((n / CHUNK - 1) & 1) * nw * CHUNK + lane;
        float s = 0.f;
        for (int i = 0; i < nw; ++i) s += ws[i * CHUNK];
        grad0[-static_cast<ptrdiff_t>(n - CHUNK + lane) * W] = -gb * s;  // gradient store
      }
    }
    cp_async_wait<D - 2>();  // frame ml - 1 - n has landed
    stage.fetch();
    const unsigned char* slot = stage.ring + (n & (D - 1)) * FRAME;
    const float* map = reinterpret_cast<const float*>(slot);
    const double* alpha = reinterpret_cast<const double*>(slot + 3 * 32 * 4);
    const double m = next ? static_cast<double>(map[lane]) : NEG;  // map read
    const double lp0 = map[32 + lane];
    // every lane computes (a padding lane's staged alphas are 0, its states
    // NEG) and selects: no divergent branch in the frame
    const float ob =
        fast_exp2(LOG2E * fminf(static_cast<float>(alpha[lane] + bb - z), 0.f));
    const float ol =
        fast_exp2(LOG2E * fminf(static_cast<float>(alpha[32 + lane] + bl - z), 0.f));
    if (next) *grad = -gb * ol;  // gradient store
    part[(n & (CHUNK - 1)) * 33 + lane] = col ? ob : 0.f;
    const double u = col ? bb + lp0 : NEG;
    const double v = col ? bl + m : NEG;
    const double me = next_warp_next ? static_cast<double>(map[64 + lane]) : NEG;
    const double ue = next_warp ? ebb + lp0 : NEG;
    const double ve = next_warp ? ebl + me : NEG;
    double ur = from_right(u, lane);
    double vr = from_right(v, lane);
    ur = lane == 31 ? ue : ur;
    vr = lane == 31 ? ve : vr;
    const double nb = lse2(u, v);
    const double nl = lse3(v, ur, vr);
    bb = col ? nb : NEG;
    bl = col ? nl : NEG;
    grad -= W;
    // every CHUNK frames (and at the last), the chunk's blank occupancy
    const int count = (n & (CHUNK - 1)) + 1;
    if (count == CHUNK || n == ml - 1) {
      __syncwarp();
      const float s = sum_lanes(part, lane);
      __syncwarp();
      const int n0 = n + 1 - count;  // the chunk's first frame
      if (nw == 1) {
        if (lane < count) {
          grad0[-static_cast<ptrdiff_t>(n0 + lane) * W] = -gb * s;  // gradient store
        }
      } else if (lane < CHUNK) {
        wsum[((n / CHUNK) & 1) * nw * CHUNK + w * CHUNK + lane] = s;
      }
    }
  }
  cp_async_wait<0>();
  if (nw > 1 && ml > 0) {
    __syncthreads();
    const int n0 = (ml - 1) / CHUNK * CHUNK;  // the last chunk's first frame
    if (w == 0 && lane < ml - n0) {
      const float* ws = wsum + (((ml - 1) / CHUNK) & 1) * nw * CHUNK + lane;
      float s = 0.f;
      for (int i = 0; i < nw; ++i) s += ws[i * CHUNK];
      grad0[-static_cast<ptrdiff_t>(n0 + lane) * W] = -gb * s;  // gradient store
    }
  }
  if (col) {
    float* zero = dlp + base + static_cast<size_t>(ml) * W + j;
    for (int t = ml; t < M; ++t, zero += W) *zero = 0.f;  // rows past mel_len
  }
}

size_t fwd_smem(int nw, int D) {
  return static_cast<size_t>(nw) * D * 256 + (2 * nw + 2) * sizeof(double);
}

size_t bwd_smem(int nw, int D) {
  return static_cast<size_t>(nw) * D * BwdStage<4>::FRAME
         + static_cast<size_t>(nw) * CHUNK * 33 * 4 + 2 * nw * CHUNK * 4
         + 4 * nw * sizeof(double);
}

template <int D>
cudaError_t launch_fwd(const void* lp, const void* text_lens, const void* mel_lens, void* ab,
                       void* al, void* logz, void* neg_logp, int B, int M, int W, int nw,
                       cudaStream_t stream) {
  constexpr auto kernel = ctc_fwd_kernel<D>;
  const size_t smem = fwd_smem(nw, D);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, 32 * nw, smem, stream>>>(
      static_cast<const float*>(lp), static_cast<const int*>(text_lens),
      static_cast<const int*>(mel_lens), static_cast<double*>(ab), static_cast<double*>(al),
      static_cast<double*>(logz), static_cast<float*>(neg_logp), M, W);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* lp, const void* ab, const void* al, const void* logz,
                       const void* g, const void* text_lens, const void* mel_lens, void* dlp,
                       int B, int M, int W, int nw, cudaStream_t stream) {
  constexpr auto kernel = ctc_bwd_kernel<D>;
  const size_t smem = bwd_smem(nw, D);
  cudaError_t err = allow_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, 32 * nw, smem, stream>>>(
      static_cast<const float*>(lp), static_cast<const double*>(ab),
      static_cast<const double*>(al), static_cast<const double*>(logz),
      static_cast<const float*>(g), static_cast<const int*>(text_lens),
      static_cast<const int*>(mel_lens), static_cast<float*>(dlp), M, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" int isp_ctc_fwd(const void* lp, const void* text_lens, const void* mel_lens,
                           void* ab, void* al, void* logz, void* neg_logp, int B, int M, int W,
                           void* stream) {
  if (W < 2 || W > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (W + 31) / 32;
  const int D = ring_frames(nw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 16) {
    err = launch_fwd<16>(lp, text_lens, mel_lens, ab, al, logz, neg_logp, B, M, W, nw, st);
  } else if (D == 8) {
    err = launch_fwd<8>(lp, text_lens, mel_lens, ab, al, logz, neg_logp, B, M, W, nw, st);
  } else {
    err = launch_fwd<4>(lp, text_lens, mel_lens, ab, al, logz, neg_logp, B, M, W, nw, st);
  }
  return static_cast<int>(err);
}

extern "C" int isp_ctc_bwd(const void* lp, const void* ab, const void* al, const void* logz,
                           const void* g, const void* text_lens, const void* mel_lens,
                           void* dlp, int B, int M, int W, void* stream) {
  if (W < 2 || W > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int nw = (W + 31) / 32;
  const int D = ring_frames(nw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 16) {
    err = launch_bwd<16>(lp, ab, al, logz, g, text_lens, mel_lens, dlp, B, M, W, nw, st);
  } else if (D == 8) {
    err = launch_bwd<8>(lp, ab, al, logz, g, text_lens, mel_lens, dlp, B, M, W, nw, st);
  } else {
    err = launch_bwd<4>(lp, ab, al, logz, g, text_lens, mel_lens, dlp, B, M, W, nw, st);
  }
  return static_cast<int>(err);
}
