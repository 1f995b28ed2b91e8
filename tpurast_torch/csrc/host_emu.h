// Host emulation of the CUDA subset the tpurast_torch kernels use, so that
// csrc/*.cu compile with a host C++20 compiler (-x c++ -DTR_HOST_EMU) and
// run on the CPU: every launch runs its blocks one after another, each
// block as blockDim.x std::threads that meet at a std::barrier in
// __syncthreads(). Only for checking the kernels' logic against their
// plain torch versions where there is no GPU (tests/test_torch_csrc.py);
// the library the port loads is always built by nvcc.
#pragma once

#include <math.h>

#include <algorithm>
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

using std::max;
using std::min;

struct tr_emu_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local tr_emu_dim3 threadIdx, blockIdx, blockDim;
inline std::barrier<>* tr_emu_block_barrier = nullptr;

inline void __syncthreads() { tr_emu_block_barrier->arrive_and_wait(); }

template <class F>
void tr_emu_launch(int grid, int block, F&& body) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    tr_emu_block_barrier = &bar;
    std::vector<std::thread> threads;
    threads.reserve(block);
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        blockDim.x = block;
        body();
      });
    }
    for (auto& th : threads) th.join();
  }
  tr_emu_block_barrier = nullptr;
}

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
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
