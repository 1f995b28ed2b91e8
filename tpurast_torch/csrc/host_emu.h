// Host emulation of the CUDA subset the tpurast_torch kernels use, so that
// csrc/*.cu compile with a host C++20 compiler (-x c++ -DTR_HOST_EMU) and
// run on the CPU: every launch runs its blocks one after another on one
// team of blockDim.x * blockDim.y std::threads that meet at a
// std::barrier in __syncthreads(). The atomics are real atomics (std::atomic_ref), since
// a block's threads run concurrently; float4, int4 and uint2 are plain
// structs. Every 32 consecutive threads of a block form a warp with a
// barrier of its own, at which the warp-wide reductions behind
// common.cuh's warp_min_i / warp_max_i / warp_add_i meet (all of a warp's
// threads must call them, as with a full mask on the card), and the
// shuffles behind warp_shfl_i / warp_shfl_f / warp_shfl_up_f too. Only for
// checking the kernels' logic against their plain torch versions where
// there is no GPU (tests/test_torch_csrc.py); the library the port loads
// is always built by nvcc.
#pragma once

#include <math.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

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

// A thread's number in its block, its warp's first thread, size and barrier,
// and one int per thread of the block for the warp-wide reductions.
constexpr int kEmuWarp = 32;
inline thread_local int tr_emu_tid = 0, tr_emu_warp_base = 0, tr_emu_warp_size = 0;
inline thread_local std::barrier<>* tr_emu_warp_barrier = nullptr;
inline int tr_emu_lanes[1024];

// op over the values of the calling thread's warp; every thread of the
// warp gets the result.
template <class Op>
int tr_emu_warp_reduce(int v, Op op) {
  tr_emu_lanes[tr_emu_tid] = v;
  tr_emu_warp_barrier->arrive_and_wait();
  int r = tr_emu_lanes[tr_emu_warp_base];
  for (int i = 1; i < tr_emu_warp_size; ++i) r = op(r, tr_emu_lanes[tr_emu_warp_base + i]);
  tr_emu_warp_barrier->arrive_and_wait();  // all have read before the next write
  return r;
}

// The value of lane `src` of the calling thread's warp (its own where the
// warp has no such lane).
inline int tr_emu_warp_shfl(int v, int src) {
  tr_emu_lanes[tr_emu_tid] = v;
  tr_emu_warp_barrier->arrive_and_wait();
  const int r = src >= 0 && src < tr_emu_warp_size ? tr_emu_lanes[tr_emu_warp_base + src] : v;
  tr_emu_warp_barrier->arrive_and_wait();  // all have read before the next write
  return r;
}

// Barrier that returns whether pred was non-zero on any thread of the block.
inline int __syncthreads_or(int pred) {
  static int flag = 0;
  __syncthreads();  // thread 0's reset below is done
  if (pred) std::atomic_ref<int>(flag).store(1);
  __syncthreads();
  const int r = std::atomic_ref<int>(flag).load();
  __syncthreads();
  if (tr_emu_tid == 0) flag = 0;
  return r;
}

// Launches of one- and two-dimensional grids and blocks (z stays 1). One
// team of blockDim threads runs the blocks one after another; no thread
// starts a block before every thread has left the one before (a barrier of
// its own, apart from __syncthreads', so that a thread that returned early
// waits there).
template <class F>
void tr_emu_launch(dim3 grid, dim3 block, F&& body) {
  const int n = (int)(block.x * block.y);
  std::barrier<> bar(n), done(n);
  tr_emu_block_barrier = &bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  for (int w = 0; w < n; w += kEmuWarp) warp_bars.push_back(std::make_unique<std::barrier<>>(min(kEmuWarp, n - w)));
  std::vector<std::thread> threads;
  threads.reserve(n);
  for (int t = 0; t < n; ++t) {
    threads.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, t / block.x);
      blockDim = block;
      gridDim = grid;
      tr_emu_tid = t;
      tr_emu_warp_base = t / kEmuWarp * kEmuWarp;
      tr_emu_warp_size = min(kEmuWarp, n - tr_emu_warp_base);
      tr_emu_warp_barrier = warp_bars[t / kEmuWarp].get();
      for (unsigned b = 0; b < grid.x * grid.y; ++b) {
        blockIdx = dim3(b % grid.x, b / grid.x);
        body();
        done.arrive_and_wait();
      }
    });
  }
  for (auto& th : threads) th.join();
  tr_emu_block_barrier = nullptr;
}

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMemoryAllocation = 2,
  cudaErrorMisalignedAddress = 716
};
// The error of the last launch: a vector load off its alignment
// (tr_emu_check_aligned), where the card would fault.
inline std::atomic<int> tr_emu_error{0};
inline cudaError_t cudaGetLastError() { return (cudaError_t)tr_emu_error.exchange(0); }

inline void tr_emu_check_aligned(const void* p, uintptr_t bytes) {
  if ((uintptr_t)p % bytes != 0) tr_emu_error.store(cudaErrorMisalignedAddress);
}

// An IEEE half's 16 bits as a float (exact; NaN payloads are not kept).
inline float tr_emu_half_to_float(unsigned h) {
  const unsigned e = (h >> 10) & 31u, m = h & 1023u;
  const float f = e == 0 ? ldexpf((float)m, -24)
                  : e == 31 ? (m ? NAN : INFINITY)
                            : ldexpf((float)(m | 1024u), (int)e - 25);
  return (h >> 15) ? -f : f;
}
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
inline long long atomicMax(long long* p, long long v) { return tr_emu_atomic_max(p, v); }

// %globaltimer's stand-in: the host's monotonic clock in ns (the clock of
// Python's time.perf_counter_ns on Linux).
inline long long tr_emu_globaltimer() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
inline void __threadfence_system() { std::atomic_thread_fence(std::memory_order_seq_cst); }

inline int __popc(unsigned v) { return __builtin_popcount(v); }

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
struct int4 {
  int x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : e == cudaErrorMisalignedAddress ? "misaligned address" : "invalid value";
}

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
