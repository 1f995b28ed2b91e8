// Shared helpers of the tpurast_torch CUDA kernels (raster.cu, resolve.cu,
// plan.cu, sampler.cu, probes.cu).
//
// The kernels are built with --fmad=false and without fast math, so every
// a*b+c below rounds twice and every division and sqrtf is correctly
// rounded: the same bits as the eager torch plain versions in
// tpurast_torch/kernels/*.py, which never contract. The min/max helpers
// propagate NaN like torch.maximum / torch.clamp (fmaxf does not).
//
// Built with TR_HOST_EMU defined (tests/test_torch_csrc.py), the same
// sources compile with a host C++ compiler against host_emu.h, which runs
// each launch's threads on the CPU.
#pragma once

#ifdef TR_HOST_EMU
#include "host_emu.h"
#define TR_LAUNCH(kernel, grid, block, stream, ...) \
  tr_emu_launch((grid), (block), [&] { kernel(__VA_ARGS__); })
#else
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <cstring>
#define TR_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? (a + b) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? (a + b) : fminf(a, b);
}

// torch.remainder / jnp.mod on floats: the sign follows the divisor.
__device__ __forceinline__ float floor_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// Round to bfloat16 (nearest even) and back, as x.to(torch.bfloat16).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
