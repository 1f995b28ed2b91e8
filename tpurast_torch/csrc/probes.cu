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
// varies. Bound by bytes: 8 B moved per pixel (16.7 MB at 1088x1920,
// 0.005 ms at 3.35 TB/s). Exact (a product by 2).
//
// A row of a rectangle moves as a scalar head up to its first 16-byte
// boundary, a body of 16-byte float4s and a scalar tail (row_move); where
// the plane and the output are not aligned alike (the plane's offset not
// a multiple of 4 floats, or an unaligned pointer) the whole row is head.
// A block's threads form teams, one thread per move of a row, and each
// team walks every blockDim.y-th row of the rectangle. A 32x128
// rectangle (32 float4s a row) takes 512 threads, 16 rows of 32, two
// vectors each; a 32x1920 band (15,360 float4s) takes 1024 threads, 2 rows
// of 480, 16 vectors each. These are the fastest block sizes of the
// three geometries on an H100 (`python -m tpurast_torch.tools.microbench
// planescale` times 128-1024 threads beside torch.mul). The row-band
// geometry launches one block per 32 rows, 34 blocks on a 1088-row frame:
// 34 of the 132 SMs move the whole plane.
#include "common.cuh"

namespace {

constexpr int kTakeWidth = 16;
constexpr int kTakeStride = kTakeWidth + 1;
constexpr int kTakeMaxRows = 4096;
constexpr int kTakeThreads = 512;
constexpr int kTakePerThread = 16;
constexpr int kScaleThreads = 512;
constexpr int kScaleBigThreads = 1024;  // for rectangles of kScaleBigMoves moves and more
constexpr int kScaleBigMoves = 8192;
constexpr int kScaleBatch = 2;

__device__ __forceinline__ float4 scale2(float4 v) {
  return make_float4(2.0f * v.x, 2.0f * v.y, 2.0f * v.z, 2.0f * v.w);
}

// Move i of a row of n columns whose scalar head (up to its first 16-byte
// boundary) is `head` columns: moves [0, nvec) are the row's float4s,
// the next ones its head and tail scalars. Sets *col to the move's first
// column and returns its width in floats (4, 1, or 0 past the last move).
__device__ __forceinline__ int row_move(int head, int nvec, int n, int i, int* col) {
  if (i < nvec) {
    *col = head + 4 * i;
    return 4;
  }
  const int j = i - nvec;
  *col = j < head ? j : j + 4 * nvec;
  return *col < n ? 1 : 0;
}

// One (block_h, block_w) rectangle per block, block (bx, by) of a 2D grid;
// thread (x, y) makes moves x, x + blockDim.x, ... of rows y, y +
// blockDim.y, ...; `moves` bounds the moves of any row. `plane` is the
// plane's first float. A rectangle whose every row lies on the 16-byte
// grid (vec_ok, the frame width and the rectangle's columns multiples of
// 4: the microbenchmark's geometries) moves float4s x, x + blockDim.x, ...
// of each row, kScaleBatch rows' loads in flight before their stores; any
// other takes each row's moves from row_move, one at a time. No division,
// and few instructions before the first load: 2048 threads per SM run
// each of them, and at 512 threads a block's rectangles must all fit on
// the card at once (4 blocks per SM, at most 32 registers).
__global__ void __launch_bounds__(1024, 2)
    plane_scale_kernel(const float* __restrict__ plane, int height, int width, int block_h, int block_w, int vec_ok,
                       int moves, float* __restrict__ out) {
  const int xa = blockIdx.x * block_w;
  const int y0 = blockIdx.y * block_h;
  const int n = min(block_w, width - xa);  // this rectangle's columns
  const int n_rows = min(block_h, height - y0);
  const int dy = blockDim.y;
  if (vec_ok && ((width | xa | n) & 3) == 0) {
    const long long row4 = width / 4;
    const float4* s = reinterpret_cast<const float4*>(plane + (long long)y0 * width + xa);
    float4* d = reinterpret_cast<float4*>(out + (long long)y0 * width + xa);
    for (int x = threadIdx.x; x < n / 4; x += blockDim.x) {
      for (int r = threadIdx.y; r < n_rows; r += dy * kScaleBatch) {
        float4 buf[kScaleBatch];
#pragma unroll
        for (int u = 0; u < kScaleBatch; ++u) {
          if (r + u * dy < n_rows) buf[u] = s[(r + u * dy) * row4 + x];
        }
#pragma unroll
        for (int u = 0; u < kScaleBatch; ++u) {
          if (r + u * dy < n_rows) d[(r + u * dy) * row4 + x] = scale2(buf[u]);
        }
      }
    }
    return;
  }
  for (int r = threadIdx.y; r < n_rows; r += dy) {
    const long long o = (long long)(y0 + r) * width + xa;  // row start, in floats
    const int head = vec_ok ? min(n, (int)(-o & 3)) : n;
    for (int i = threadIdx.x; i < moves; i += blockDim.x) {
      int col;
      const int w = row_move(head, (n - head) / 4, n, i, &col);
      if (w == 4) {
        *reinterpret_cast<float4*>(out + o + col) = scale2(*reinterpret_cast<const float4*>(plane + o + col));
      } else if (w == 1) {
        out[o + col] = 2.0f * plane[o + col];
      }
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

// threads: the block size to aim at, 32-1024 (0: the default below).
extern "C" int tr_plane_scale(const float* in, int plane, int height, int width, int block_h, int block_w,
                              int threads, float* out, void* stream) {
  const int blocks_x = (width + block_w - 1) / block_w;
  const int blocks_y = (height + block_h - 1) / block_h;
  if ((threads != 0 && (threads < 32 || threads > 1024)) || blocks_y > 65535) return (int)cudaErrorInvalidValue;
  const float* src = in + (long long)plane * height * width;
  // float4 moves need the plane and the output 16-byte aligned at the same
  // columns.
  const int vec_ok = ((uintptr_t)src % 16 == 0) && ((uintptr_t)out % 16 == 0);
  // Moves of a full rectangle's row: n / 4 where every row starts and ends
  // on a 16-byte boundary, else at most n / 4 float4s and 6 scalars (all
  // scalars without vec_ok).
  const int n = block_w < width ? block_w : width;
  const int moves = !vec_ok ? n : width % 4 == 0 && block_w % 4 == 0 ? n / 4 : n / 4 + 6 < n ? n / 4 + 6 : n;
  if (threads == 0) threads = (long long)block_h * moves >= kScaleBigMoves ? kScaleBigThreads : kScaleThreads;
  const int team = moves < threads ? moves : threads;
  const int rows = threads / team < block_h ? threads / team : block_h;
  TR_LAUNCH(plane_scale_kernel, dim3(blocks_x, blocks_y), dim3(team, rows), stream, src, height, width, block_h,
            block_w, vec_ok, moves, out);
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
