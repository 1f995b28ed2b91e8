// The device probes of the microbenchmarks (tpurast_torch/tools).
//
// vmem_take replaces the Pallas kernel of tools/microbench.py cmd_vmemtake
// (run, the kernel body at :256-258): out[i] = sum_j table[idx[i], j] for
// a 4096 x 16 f32 table held in on-chip memory and 2,073,600 int32
// indices. The TPU kernel keeps the whole 256 KB table in VMEM. Here the
// table stays on chip too, but a block may hold at most 227 KB of shared
// memory, so each block stages it in two halves (rows [0, h) and [h, R),
// h = ceil(R / 2), 139,264 B each with the row stride padded to 17 words)
// as dynamic shared memory, and gives each of its indices its row sum
// during the pass that holds the row. The 17-word stride spreads the rows
// a warp reads over the 32 banks (a 16-word stride would put every row on
// the same two). Sums run left to right over the 16
// columns, as the plain version (kernels/probes.py) adds them, so the two
// agree bit for bit. An index outside [0, R) is clamped into it (JAX's
// gather semantics). What bounds it: staging the table, 272 KB from L2
// per block of 8,192 indices (~70 MB over the frame's 254 blocks), against
// 16.6 MB of index and output traffic. A 2-block cluster that reads the
// partner's half through distributed shared memory would stage each
// half once per pair; that is later work. The host emulation
// (host_emu.h) models static shared memory only, so this kernel is left
// out of it.
//
// plane_scale replaces the three Pallas kernels of
// tools/microbench_pipeline.py main (:32-45, :60-73, :86-97): out =
// 2 * gbuf[plane] over a (P, H, W) f32 G-buffer, one block per
// (block_h, block_w) rectangle of the frame. The TPU probes measured the
// cost of DMAing a fat block per grid step; on the card the kernel reads
// only the plane it scales, and the launch geometry (32x128 tiles of the
// 24-plane buffer or of a one-plane buffer, 32x1920 row bands) is what
// varies. Bound by bytes: 8 B moved per pixel. Exact (a product by 2).

#include "common.cuh"

namespace {

constexpr int kTakeWidth = 16;
constexpr int kTakeStride = kTakeWidth + 1;
constexpr int kTakeMaxRows = 4096;
constexpr int kTakeThreads = 512;
constexpr int kTakePerThread = 16;
constexpr int kScaleThreads = 256;

__global__ void plane_scale_kernel(const float* __restrict__ in, int plane, int height, int width,
                                   int block_h, int block_w, int blocks_x, float* __restrict__ out) {
  const int by = blockIdx.x / blocks_x;
  const int bx = blockIdx.x % blocks_x;
  // The threads cover the rectangle as rows of `cols` consecutive columns
  // (coalesced), row_step rows at a time.
  const int cols = min(block_w, (int)blockDim.x);
  const int row_step = blockDim.x / cols;
  const int c0 = threadIdx.x % cols;
  const int r0 = threadIdx.x / cols;
  if (r0 >= row_step) return;
  const float* src = in + (long long)plane * height * width;
  for (int r = r0; r < block_h; r += row_step) {
    const int y = by * block_h + r;
    if (y >= height) break;
    const long long row = (long long)y * width;
    for (int c = c0; c < block_w; c += cols) {
      const int x = bx * block_w + c;
      if (x >= width) break;
      out[row + x] = 2.0f * src[row + x];
    }
  }
}

#ifndef TR_HOST_EMU
__global__ void __launch_bounds__(kTakeThreads)
    vmem_take_kernel(const float* __restrict__ table, int rows, const int* __restrict__ idx, long long n,
                     float* __restrict__ out) {
  extern __shared__ float half_table[];
  const int half = (rows + 1) / 2;
  const long long base = (long long)blockIdx.x * kTakeThreads * kTakePerThread + threadIdx.x;
  int row[kTakePerThread];
  float acc[kTakePerThread];
#pragma unroll
  for (int k = 0; k < kTakePerThread; ++k) {
    const long long i = base + (long long)k * kTakeThreads;
    row[k] = i < n ? min(max(idx[i], 0), rows - 1) : -1;
    acc[k] = 0.0f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    const int r0 = pass * half;
    const int r1 = min(rows, r0 + half);
    const float* src = table + (long long)r0 * kTakeWidth;
    for (int j = threadIdx.x; j < (r1 - r0) * kTakeWidth; j += kTakeThreads) {
      half_table[(j / kTakeWidth) * kTakeStride + j % kTakeWidth] = src[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTakePerThread; ++k) {
      if (row[k] >= r0 && row[k] < r1) {
        const float* r = half_table + (row[k] - r0) * kTakeStride;
        float s = r[0];
#pragma unroll
        for (int c = 1; c < kTakeWidth; ++c) s += r[c];
        acc[k] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kTakePerThread; ++k) {
    const long long i = base + (long long)k * kTakeThreads;
    if (i < n) out[i] = acc[k];
  }
}
#endif

}  // namespace

extern "C" int tr_plane_scale(const float* in, int plane, int height, int width, int block_h, int block_w,
                              float* out, void* stream) {
  const int blocks_x = (width + block_w - 1) / block_w;
  const int blocks_y = (height + block_h - 1) / block_h;
  TR_LAUNCH(plane_scale_kernel, blocks_x * blocks_y, kScaleThreads, stream, in, plane, height, width,
            block_h, block_w, blocks_x, out);
  return (int)cudaGetLastError();
}

#ifndef TR_HOST_EMU
extern "C" int tr_vmem_take(const float* table, int rows, const int* idx, long long n, float* out,
                            void* stream) {
  if (rows < 1 || rows > kTakeMaxRows) return (int)cudaErrorInvalidValue;
  const int half = (rows + 1) / 2;
  const int smem = half * kTakeStride * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(vmem_take_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (long long)kTakeThreads * kTakePerThread;
  const int blocks = (int)((n + per_block - 1) / per_block);
  if (blocks > 0) {
    vmem_take_kernel<<<blocks, kTakeThreads, smem, (cudaStream_t)stream>>>(table, rows, idx, n, out);
  }
  return (int)cudaGetLastError();
}
#endif
