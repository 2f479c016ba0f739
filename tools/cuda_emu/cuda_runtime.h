// Host stand-ins for the CUDA runtime types and intrinsics the port's
// sources use, for the CPU emulation (emu.h).
#pragma once
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <cstdio>
#include <algorithm>
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3() {} dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
template <class K> inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
template <class K> inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#include "emu.h"
