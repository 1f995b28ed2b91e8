// Host emulation of the CUDA subset the tpurast_torch kernels use, so that
// csrc/*.cu compile with a host C++20 compiler (-x c++ -DTR_HOST_EMU) and
// run on the CPU: every launch runs its blocks one after another, each
// block as blockDim.x * blockDim.y std::threads that meet at a
// std::barrier in __syncthreads(). The atomics are real atomics (std::atomic_ref), since
// a block's threads run concurrently; float4 is a plain struct. Only for
// checking the kernels' logic against their plain torch versions where
// there is no GPU (tests/test_torch_csrc.py); the library the port loads
// is always built by nvcc.
#pragma once

#include <math.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
using cudaStream_t = void*;
inline std::barrier<>* tr_emu_block_barrier = nullptr;

inline void __syncthreads() { tr_emu_block_barrier->arrive_and_wait(); }

// Launches of one- and two-dimensional grids and blocks (z stays 1).
template <class F>
void tr_emu_launch(dim3 grid, dim3 block, F&& body) {
  const int n = (int)(block.x * block.y);
  for (unsigned b = 0; b < grid.x * grid.y; ++b) {
    std::barrier<> bar(n);
    tr_emu_block_barrier = &bar;
    std::vector<std::thread> threads;
    threads.reserve(n);
    for (int t = 0; t < n; ++t) {
      threads.emplace_back([&, b, t] {
        blockIdx = dim3(b % grid.x, b / grid.x);
        threadIdx = dim3(t % block.x, t / block.x);
        blockDim = block;
        gridDim = grid;
        body();
      });
    }
    for (auto& th : threads) th.join();
  }
  tr_emu_block_barrier = nullptr;
}

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t bytes, void*) {
  std::memset(p, value, bytes);
  return cudaSuccess;
}

// Atomics on global or shared memory; each returns the old value.
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }

template <class T>
T tr_emu_atomic_max(T* p, T v) {
  std::atomic_ref<T> a(*p);
  T old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

template <class T>
T tr_emu_atomic_min(T* p, T v) {
  std::atomic_ref<T> a(*p);
  T old = a.load();
  while (v < old && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

inline int atomicMax(int* p, int v) { return tr_emu_atomic_max(p, v); }
inline int atomicMin(int* p, int v) { return tr_emu_atomic_min(p, v); }
inline unsigned long long atomicMax(unsigned long long* p, unsigned long long v) { return tr_emu_atomic_max(p, v); }

inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline const char* cudaGetErrorString(cudaError_t e) { return e == cudaSuccess ? "no error" : "invalid value"; }

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
