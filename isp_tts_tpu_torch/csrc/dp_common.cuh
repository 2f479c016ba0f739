// The warp-resident layout shared by the aligner's dynamic-programming
// kernels, K3 (mas.cu) and K4 (ctc.cu): a row of columns is a recurrence
// over frames (or mel rows) whose step reads only the previous row, the
// column itself and one neighbour. The design keeps nothing but that step on
// the per-frame dependency chain:
//
// - Columns in registers. A block of nw warps owns one sequence; warp w
//   holds column blocks [w*C, w*C + C) of 32 columns each, lane l of block k
//   column j = 32*(w*C + k) + l. So a 32-column block is one register across
//   the warp: a neighbour is one shuffle (a rotation by one lane; lane 0 or
//   31 takes the next block's value), a 32-bit ballot is the block's row of
//   choice bits, and a row's stores are coalesced.
// - Rows over warps. A warp runs its instructions in order, so a frame
//   costs about its instruction count: K4's f64 step (~40 instructions a
//   column) runs one block a warp (C = 1), K3's f32 step (~10) up to
//   C_MAX = 8. Past that the row is split over nw warps, which run on the
//   SM's four schedulers; only a warp's edge column crosses, through shared
//   memory, with one barrier per frame (the block is the sequence's warps,
//   so the barrier is __syncthreads). The edge slots alternate by frame
//   parity, so one barrier orders both the write and the next frame's
//   overwrite.
// - The map off the chain. Each lane stages the map values (and K4's
//   backward its alphas) that it alone reads into a ring of D frames in
//   shared memory with cp.async, D - 1 frames ahead of the wavefront, one
//   commit group per frame: a frame's step waits for its own group (which
//   landed long before) and reads shared memory only. A lane reads only what
//   it copied, so no barrier orders the ring.
//
// Plain CUDA C++: every includer is its own translation unit, so the
// helpers sit in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronous; zero-fill where !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// 8 bytes global -> shared, asynchronous; zero-fill where !pred.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x and log2(x), one MUFU instruction each (relative error ~2^-22;
// subnormal inputs and results flushed to 0, which the tails never need)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Lane l gets lane l-1's value (lane 0 gets lane 31's): the left neighbour
// within a block; lane 0 takes the previous block's rotated value.
template <typename T>
__device__ __forceinline__ T from_left(T v, int lane) {
  return __shfl_sync(FULL_MASK, v, (lane + 31) & 31);
}

// Lane l gets lane l+1's value (lane 31 gets lane 0's).
template <typename T>
__device__ __forceinline__ T from_right(T v, int lane) {
  return __shfl_sync(FULL_MASK, v, (lane + 1) & 31);
}

// Warps and column blocks a lane for a row of n columns: the fewest warps
// that hold it with at most c_max blocks a lane, then the fewest blocks.
struct RowSplit {
  int warps, blocks;
};

inline RowSplit row_split(int n, int c_max) {
  const int warps = (n + 32 * c_max - 1) / (32 * c_max);
  return {warps, (n + 32 * warps - 1) / (32 * warps)};
}

// The largest dynamic shared memory a block may take (H100: 227 KB).
constexpr int kSmemOptIn = 232448;

// Raise a kernel's dynamic shared memory limit to the card's maximum once
// per device (a repeated raise is harmless), so that its launches make no
// other runtime call and can be captured in a CUDA graph.
template <auto kKernel>
cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (bytes > static_cast<size_t>(kSmemOptIn)) return cudaErrorInvalidValue;
  static unsigned long long raised = 0;  // bit d: device d's limit is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= 64 || !((raised >> dev) & 1ull))) {
    err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemOptIn);
    if (err == cudaSuccess && dev < 64) raised |= 1ull << dev;
  }
  return err;
}

}  // namespace
