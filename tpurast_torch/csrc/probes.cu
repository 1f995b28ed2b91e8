// The device probes of the microbenchmarks (tpurast_torch/tools).
//
// vmem_take replaces the Pallas kernel of tools/microbench.py cmd_vmemtake
// (run, the kernel body at :256-258): out[i] = sum_j table[idx[i], j] for
// a 4096 x 16 f32 table held in on-chip memory and 2,073,600 int32
// indices. The TPU kernel keeps the whole 256 KB table in VMEM. On the card
// the table's on-chip home is the caches: 256 KB is at home in every SM's
// L1 and in L2, so nothing is staged and no block waits at a barrier. What
// bounds such a gather is not bytes (16.6 MB of indices and sums, 0.005 ms
// at 3.35 TB/s) but how many cache lines one load instruction touches: with
// a thread per index a warp's 16-byte load reads 32 rows and takes 32 tag
// lookups for 512 bytes. Here kTakeLanes = 4 neighbouring lanes share a row
// and load its four 16-byte quarters (ld.global.nc), so a warp's load reads
// 8 whole rows: 8 lines, 16 fully used sectors. A warp takes 32 indices
// (one coalesced 128-byte streaming load), and in each of 4 rounds its 8
// lane groups take 8 of them (the row number by shuffle). The sum runs left
// to right over the 16 columns, as the plain version (kernels/probes.py)
// adds them, so the two agree bit for bit: quarter 0's lane adds its four
// columns, hands the sum to quarter 1's lane by shuffle, and so on; three
// steps, the lanes of the later quarters redoing theirs with the final
// carry. The sums return to the lanes that own the indices by shuffle and
// leave as one coalesced streaming store. An index outside [0, R) is clamped
// into it (the port's rule; the tool passes none). Designs measured on an
// H100 and not kept (PERF.md has the times): the table staged in shared
// memory in two halves per block (the TPU design carried over), each half
// staged once per 2-block cluster and the partner's read through
// distributed shared memory, the halves split over pairs of blocks, and a
// thread per index with four 16-byte loads.
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

constexpr int kTakeLanes = 4;                // lanes that share a row, one 16-byte quarter each
constexpr int kTakeGroups = 32 / kTakeLanes;  // rows a warp reads per round
constexpr int kTakeThreads = 128;
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

// s + v.x + v.y + v.z + v.w, left to right.
__device__ __forceinline__ float add4(float s, float4 v) {
  s += v.x;
  s += v.y;
  s += v.z;
  s += v.w;
  return s;
}

// Thread t of the grid owns index t, so warp w takes [32 w, 32 w + 32);
// every lane of a warp runs every step (the shuffles take the full mask),
// and a lane past n reads row 0 and stores nothing.
__global__ void __launch_bounds__(kTakeThreads)
    vmem_take_kernel(const float4* __restrict__ table4, int rows, const int* __restrict__ idx, long long n,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int part = lane % kTakeLanes, grp = lane / kTakeLanes;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int row = i < n ? min(max(ld_stream_i(idx + i), 0), rows - 1) : 0;
  float4 v[kTakeLanes];
#pragma unroll
  for (int k = 0; k < kTakeLanes; ++k) {
    const long long r = warp_shfl_i(row, k * kTakeGroups + grp);
    v[k] = ldg_f4(table4 + 4 * r + part);
  }
  float res = 0.0f;
#pragma unroll
  for (int k = 0; k < kTakeLanes; ++k) {
    float cur = ((v[k].x + v[k].y) + v[k].z) + v[k].w;  // final for quarter 0
#pragma unroll
    for (int step = 1; step < kTakeLanes; ++step) {
      const float nxt = add4(warp_shfl_up_f(cur, 1), v[k]);
      if (part >= step) cur = nxt;  // final for quarter `step`
    }
    // The group's last lane holds the sum of index k * kTakeGroups + grp.
    const float got = warp_shfl_f(cur, kTakeLanes * (lane % kTakeGroups) + kTakeLanes - 1);
    if (lane / kTakeGroups == k) res = got;
  }
  if (i < n) st_stream_f(out + i, res);
}

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

extern "C" int tr_vmem_take(const float* table, int rows, const int* idx, long long n, float* out,
                            void* stream) {
  if (rows < 1 || (uintptr_t)table % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kTakeThreads - 1) / kTakeThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    TR_LAUNCH(vmem_take_kernel, dim3((unsigned)blocks), dim3(kTakeThreads), stream,
              reinterpret_cast<const float4*>(table), rows, idx, n, out);
  }
  return (int)cudaGetLastError();
}

#ifndef TR_HOST_EMU
extern "C" int tr_vmem_take_info(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, vmem_take_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, vmem_take_kernel, kTakeThreads, 0);
}
#endif
