// Shared helpers of the tpurast_torch CUDA kernels (raster.cu, resolve.cu,
// plan.cu, sampler.cu, shade.cu, probes.cu, bin.cu, setup.cu, encode.cu).
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
#include <cuda_fp16.h>
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

// Integer min / max / sum over the 32 lanes of the calling warp; every lane gets
// the result. All 32 lanes must call (full mask), so the block size is a
// multiple of 32. One redux.sync instruction on the card; in the host
// emulation the warp's threads meet at their own barrier (host_emu.h).
__device__ __forceinline__ int warp_min_i(int v) {
#ifdef TR_HOST_EMU
  return tr_emu_warp_reduce(v, [](int a, int b) { return a < b ? a : b; });
#else
  return __reduce_min_sync(0xffffffffu, v);
#endif
}

__device__ __forceinline__ int warp_max_i(int v) {
#ifdef TR_HOST_EMU
  return tr_emu_warp_reduce(v, [](int a, int b) { return a > b ? a : b; });
#else
  return __reduce_max_sync(0xffffffffu, v);
#endif
}

__device__ __forceinline__ int warp_add_i(int v) {
#ifdef TR_HOST_EMU
  return tr_emu_warp_reduce(v, [](int a, int b) { return a + b; });
#else
  return __reduce_add_sync(0xffffffffu, v);
#endif
}

// The lanes of the calling warp whose pred holds, as bits (bit i: lane i).
// All 32 lanes must call. vote.sync on the card; in the host emulation the
// warp's threads meet at their own barrier (host_emu.h).
__device__ __forceinline__ unsigned warp_ballot(bool pred) {
#ifdef TR_HOST_EMU
  return (unsigned)tr_emu_warp_reduce(pred ? (int)(1u << (tr_emu_tid - tr_emu_warp_base)) : 0,
                                      [](int a, int b) { return a | b; });
#else
  return __ballot_sync(0xffffffffu, pred);
#endif
}

// A barrier of the calling warp that also orders its lanes' shared-memory
// accesses (__syncwarp). All 32 lanes must call.
__device__ __forceinline__ void warp_sync() {
#ifdef TR_HOST_EMU
  tr_emu_warp_barrier->arrive_and_wait();
#else
  __syncwarp();
#endif
}

// Vector loads through the read-only data path (ld.global.nc): 4, 8 and
// 16 bytes, p aligned to as many. The card faults on a misaligned vector
// load; the host emulation records it and the launch returns
// cudaErrorMisalignedAddress (host_emu.h).
__device__ __forceinline__ unsigned ldg_u32(const unsigned* p) {
#ifdef TR_HOST_EMU
  tr_emu_check_aligned(p, 4);
  return *p;
#else
  return __ldg(p);
#endif
}

__device__ __forceinline__ uint2 ldg_u2(const uint2* p) {
#ifdef TR_HOST_EMU
  tr_emu_check_aligned(p, 8);
  return *p;
#else
  return __ldg(p);
#endif
}

// A value of another lane of the calling warp: warp_shfl_* of lane `src`,
// warp_shfl_up_f of the lane `delta` below (a lane with none below gets its
// own). All 32 lanes must call. shfl.sync on the card; in the host
// emulation the warp's threads exchange at their own barrier (host_emu.h).
__device__ __forceinline__ int warp_shfl_i(int v, int src) {
#ifdef TR_HOST_EMU
  return tr_emu_warp_shfl(v, src);
#else
  return __shfl_sync(0xffffffffu, v, src);
#endif
}

__device__ __forceinline__ float warp_shfl_f(float v, int src) {
#ifdef TR_HOST_EMU
  return __uint_as_float((unsigned)tr_emu_warp_shfl((int)__float_as_uint(v), src));
#else
  return __shfl_sync(0xffffffffu, v, src);
#endif
}

__device__ __forceinline__ float warp_shfl_up_f(float v, int delta) {
#ifdef TR_HOST_EMU
  const int lane = tr_emu_tid - tr_emu_warp_base;
  return __uint_as_float((unsigned)tr_emu_warp_shfl((int)__float_as_uint(v), lane >= delta ? lane - delta : lane));
#else
  return __shfl_up_sync(0xffffffffu, v, delta);
#endif
}

__device__ __forceinline__ float4 ldg_f4(const float4* p) {
#ifdef TR_HOST_EMU
  tr_emu_check_aligned(p, 16);
  return *p;
#else
  return __ldg(p);
#endif
}

// A 16-byte store, p aligned to 16 bytes (the card faults on a misaligned
// one; the host emulation records it as ldg_f4 does).
__device__ __forceinline__ void st_f4(float4* p, float4 v) {
#ifdef TR_HOST_EMU
  tr_emu_check_aligned(p, 16);
#endif
  *p = v;
}

// A 4-byte store, p aligned to 4 bytes (checked as st_f4 checks).
__device__ __forceinline__ void st_u32(unsigned* p, unsigned v) {
#ifdef TR_HOST_EMU
  tr_emu_check_aligned(p, 4);
#endif
  *p = v;
}

// Streaming 4-byte load and store (ld.global.cs, st.global.cs: evict
// first), for data that passes once and should not push reused lines out
// of L1 / L2.
__device__ __forceinline__ int ld_stream_i(const int* p) {
#ifdef TR_HOST_EMU
  return *p;
#else
  return __ldcs(p);
#endif
}

__device__ __forceinline__ void st_stream_f(float* p, float v) {
#ifdef TR_HOST_EMU
  *p = v;
#else
  __stcs(p, v);
#endif
}

// A streaming 16-byte load (ld.global.cs), p aligned to 16 bytes (checked
// as ldg_f4 checks).
__device__ __forceinline__ float4 ld_stream_f4(const float4* p) {
#ifdef TR_HOST_EMU
  tr_emu_check_aligned(p, 16);
  return *p;
#else
  return __ldcs(p);
#endif
}

// x^y by the card's fast path (__powf: lg2.approx, a product, ex2.approx;
// for x > 0 at most 2 + floor(|1.173 y log2 x|) ulps from the exact power);
// the host emulation: exp2f(y * log2f(x)).
__device__ __forceinline__ float fast_powf(float x, float y) {
#ifdef TR_HOST_EMU
  return exp2f(y * log2f(x));
#else
  return __powf(x, y);
#endif
}

// The card's %globaltimer in ns (the host emulation: the host's monotonic
// clock).
__device__ __forceinline__ long long global_ns() {
#ifdef TR_HOST_EMU
  return tr_emu_globaltimer();
#else
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
#endif
}

// A frame's stage marks that fall where a hand-written kernel starts or
// ends (trace.cu). Given a mark's word, a kernel's first block stamps the
// time it starts (stamp_start, first thing), and each block, once all its
// threads are done, raises the word to the time it ends (stamp_end, last
// thing), so that the word holds the end of the last block; the frame's
// first mark zeroed it. nullptr: no mark, and no barrier.
__device__ __forceinline__ void stamp_start(long long* mark) {
  if (mark != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    *mark = global_ns();
  }
}

__device__ __forceinline__ void stamp_end(long long* mark) {
  if (mark == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) atomicMax(mark, global_ns());
}

// The float a bfloat16's 16 bits stand for.
__device__ __forceinline__ float bf16_bits(unsigned bits) { return __uint_as_float(bits << 16); }

// The float an IEEE half's 16 bits stand for (exact).
__device__ __forceinline__ float f16_bits(unsigned bits) {
#ifdef TR_HOST_EMU
  return tr_emu_half_to_float(bits & 0xFFFFu);
#else
  return __half2float(__ushort_as_half((unsigned short)bits));
#endif
}
