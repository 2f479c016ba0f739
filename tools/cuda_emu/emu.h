// CPU emulation of the CUDA the port's tile cores use (see emubuild.py):
// one block at a time, one ucontext fiber per thread, cooperative
// scheduling; warp collectives (ldmatrix, mma.sync, shuffles, ballots) deposit each
// lane's operands, meet at a warp barrier, compute each lane's result from
// all 32 lanes' operands as the PTX ISA lays the fragments out, and meet
// again. Products are summed in double and rounded once. Shared memory
// starts as NaN bytes, so a read before a write shows.
#pragma once
#include <ucontext.h>
#include <vector>
#include <functional>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdio>
#include <cstdlib>

namespace emu {

struct Barrier {
  int n = 0, count = 0;
  long gen = 0;
};

struct Fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  bool done = false;
  dim3 tidx;
  int lane, warp;
};

struct Slot {
  uint64_t a[8];
  uint64_t b[4];
  float c[8];
  const void* ptr;
};

struct Block {
  std::vector<Fiber> fibers;
  ucontext_t sched;
  int cur = -1;
  Barrier block_bar;
  std::vector<Barrier> warp_bar;
  std::vector<Slot> slots;  // per thread
  std::vector<unsigned char> smem;
  long progress = 0;
};

inline Block*& blk() { static Block* b = nullptr; return b; }
inline dim3& block_idx() { static dim3 d; return d; }
inline dim3& grid_dim() { static dim3 d; return d; }
inline dim3& block_dim() { static dim3 d; return d; }
inline Fiber& me() { return blk()->fibers[blk()->cur]; }

inline void yield() { swapcontext(&me().ctx, &blk()->sched); }

inline void arrive(Barrier& b) {
  long my = b.gen;
  blk()->progress++;
  if (++b.count == b.n) { b.count = 0; b.gen++; return; }
  while (b.gen == my) yield();
}

inline void syncthreads() { arrive(blk()->block_bar); }
inline void syncwarp() { arrive(blk()->warp_bar[me().warp]); }
inline Slot& slot(int lane) { return blk()->slots[me().warp * 32 + lane]; }
inline Slot& myslot() { return slot(me().lane); }

inline std::function<void()>& body() { static std::function<void()> f; return f; }
inline void entry() { body()(); blk()->fibers[blk()->cur].done = true; }

template <class K, class... A>
void launch(K kernel, dim3 grid, int threads, int smem_bytes, void*, A... args) {
  grid_dim() = grid;
  block_dim() = dim3(threads);
  body() = [=]() { kernel(args...); };
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        Block b;
        blk() = &b;
        block_idx() = dim3(x, y, z);
        b.fibers.resize(threads);
        b.block_bar.n = threads;
        b.warp_bar.resize((threads + 31) / 32);
        for (auto& w : b.warp_bar) w.n = 32;
        b.slots.resize(threads);
        b.smem.assign(smem_bytes + 64, 0xFF);  // uninitialised: NaN bytes
        for (int t = 0; t < threads; ++t) {
          Fiber& f = b.fibers[t];
          f.stack.resize(1 << 18);
          f.tidx = dim3(t);
          f.lane = t % 32;
          f.warp = t / 32;
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = f.stack.data();
          f.ctx.uc_stack.ss_size = f.stack.size();
          f.ctx.uc_link = &b.sched;
          makecontext(&f.ctx, (void (*)())entry, 0);
        }
        long stall = 0;
        for (;;) {
          bool alive = false;
          long before = b.progress;
          for (int t = 0; t < threads; ++t) {
            if (b.fibers[t].done) continue;
            alive = true;
            b.cur = t;
            swapcontext(&b.sched, &b.fibers[t].ctx);
          }
          if (!alive) break;
          if (b.progress == before) {
            if (++stall > 3) {
              fprintf(stderr, "emu: deadlock in block (%u,%u,%u)\n", x, y, z);
              abort();
            }
          } else {
            stall = 0;
          }
        }
        blk() = nullptr;
      }
}

inline unsigned char* dyn_smem() { return blk()->smem.data(); }

// ------------------------------------------------------------ collectives
template <class T>
T shfl_xor(T v, int mask) {
  static_assert(sizeof(T) <= 8, "");
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  myslot().a[0] = u;
  syncwarp();
  uint64_t o = slot(me().lane ^ mask).a[0];
  syncwarp();
  T r;
  std::memcpy(&r, &o, sizeof(T));
  return r;
}

// lane `src` (mod 32)'s value of v
template <class T>
T shfl_from(T v, int src) {
  static_assert(sizeof(T) <= 8, "");
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  myslot().a[0] = u;
  syncwarp();
  uint64_t o = slot(src & 31).a[0];
  syncwarp();
  T r;
  std::memcpy(&r, &o, sizeof(T));
  return r;
}

// bit l: lane l's predicate
inline unsigned ballot(bool pred) {
  myslot().a[0] = pred ? 1 : 0;
  syncwarp();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= unsigned(slot(l).a[0] & 1) << l;
  syncwarp();
  return r;
}

inline void ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  myslot().ptr = p;
  syncwarp();
  const int l = me().lane;
  for (int i = 0; i < 4; ++i) {
    if (!trans) {
      const unsigned char* row = (const unsigned char*)slot(8 * i + l / 4).ptr;
      std::memcpy(&r[i], row + 4 * (l % 4), 4);
    } else {
      const unsigned char* r0 = (const unsigned char*)slot(8 * i + 2 * (l % 4)).ptr;
      const unsigned char* r1 = (const unsigned char*)slot(8 * i + 2 * (l % 4) + 1).ptr;
      uint16_t lo, hi;
      std::memcpy(&lo, r0 + 2 * (l / 4), 2);
      std::memcpy(&hi, r1 + 2 * (l / 4), 2);
      r[i] = uint32_t(lo) | (uint32_t(hi) << 16);
    }
  }
  syncwarp();
}

inline float bf(uint16_t u) { return __uint_as_float(uint32_t(u) << 16); }
inline float tf(uint32_t u) { return __uint_as_float(u & ~0x1fffu); }

// d = a.b + c, m16n8k16 bf16 (tf32 = false) or m16n8k8 tf32
inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1, bool tf32) {
  Slot& s = myslot();
  for (int i = 0; i < 4; ++i) s.a[i] = a[i];
  s.b[0] = b0;
  s.b[1] = b1;
  for (int i = 0; i < 4; ++i) s.c[i] = d[i];
  syncwarp();
  const int K = tf32 ? 8 : 16;
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    const Slot& o = slot(l);
    if (tf32) {
      A[g][t] = tf(o.a[0]); A[g + 8][t] = tf(o.a[1]);
      A[g][t + 4] = tf(o.a[2]); A[g + 8][t + 4] = tf(o.a[3]);
      B[t][g] = tf(o.b[0]); B[t + 4][g] = tf(o.b[1]);
    } else {
      for (int e = 0; e < 2; ++e) {
        A[g][2 * t + e] = bf(uint16_t(o.a[0] >> (16 * e)));
        A[g + 8][2 * t + e] = bf(uint16_t(o.a[1] >> (16 * e)));
        A[g][2 * t + 8 + e] = bf(uint16_t(o.a[2] >> (16 * e)));
        A[g + 8][2 * t + 8 + e] = bf(uint16_t(o.a[3] >> (16 * e)));
        B[2 * t + e][g] = bf(uint16_t(o.b[0] >> (16 * e)));
        B[2 * t + 8 + e][g] = bf(uint16_t(o.b[1] >> (16 * e)));
      }
    }
  }
  const int l = me().lane, g = l / 4, t = l % 4;
  const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  float out[4];
  for (int i = 0; i < 4; ++i) {
    double acc = s.c[i];
    for (int k = 0; k < K; ++k) acc += double(A[rows[i]][k]) * double(B[k][cols[i]]);
    out[i] = float(acc);
  }
  syncwarp();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

inline uint32_t to_tf32(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x1000u;
  return u & ~0x1fffu;
}

}  // namespace emu

#define threadIdx (emu::me().tidx)
#define blockIdx (emu::block_idx())
#define gridDim (emu::grid_dim())
#define blockDim (emu::block_dim())
inline void __syncthreads() { emu::syncthreads(); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) { return emu::shfl_xor(v, m); }
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return emu::shfl_from(v, src); }
inline unsigned __ballot_sync(unsigned, bool pred) { return emu::ballot(pred); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::syncwarp(); }
inline float atomicAdd(float* p, float v) { float o = *p; *p = o + v; return o; }
inline uintptr_t __cvta_generic_to_shared(const void* p) { return (uintptr_t)p; }
