// Visibility raster: depth and winning face id per pixel.
//
// Replaces tpurast/kernels/raster.py::_raster_kernel (a Pallas kernel over
// (tile, 128-triangle segment) grid steps). Plain torch version:
// tpurast_torch/kernels/raster.py::rasterize_tiles_plain.
//
// Work: a binned (tile, face) pair evaluates only the pixels of its tile
// inside its face's pixel rectangle, rows [floor(ymin) - 1, floor(ymax) + 1]
// and columns [floor(xmin) - 1, floor(xmax) + 1] of the screen AABB from
// triangle_setup (the reference widens its 8-row groups by the same pixel,
// raster.py:140-149; faces crossing w = 0 carry the whole screen). On the
// 1920x1080 smoke frame that is 6.75M evaluations for 203k pairs, against
// 833M for every pixel of every pair's tile.
//
// Schedule: the work unit is (tile, sub-rectangle, chunk of at most kChunk
// pairs of its bin), so a dense tile (18,934 pairs on the smoke frame's
// horizon) spreads over ~150 units instead of one block. A tile of at most
// kMaxTilePx pixels is one sub-rectangle; a larger one is cut into
// sub-rectangles of at most kMaxTilePx pixels (tile_subs: 128 columns by 32
// rows for tiles taller than 32 rows, else the tile's rows over as many
// whole 128-column strips as fit), so the shared key buffer stays 32 KB for every tile
// shape the reference takes (up to 112 rows by any multiple of 128
// columns). raster_units_kernel (one block) turns the bin offsets into each
// tile's first unit and each unit's tile; raster_kernel runs a persistent
// grid (as many blocks as fit on the card at once) whose blocks pull units
// from an atomic counter. A unit reads its chunk's face ids and AABBs,
// stages the setup fields and rectangle of each pair whose rectangle
// reaches its sub-rectangle (the others cost those two reads and nothing
// more), clears the union of the rectangles in a shared buffer of 64-bit
// keys, lets each warp take one pair at a time with its lanes over the
// rectangle's pixels, and merges each key into the shared buffer with
// atomicMax. The unit then merges its union box into a global key buffer
// (zeroed per frame) with one atomicMax per touched pixel, and
// raster_unpack_kernel writes the (2, Hp, Wp) f32 output. The host needs no
// count from the device: the grid sizes are fixed by the card and the frame
// size, and the unit table by the pair list's length (at most
// n_subs * (n_tiles + ceil(pair slots / kChunk)) units).
//
// Keys are depth_bits << 32 | (face_id + 1). Covered depths lie in [0, 1]
// (-0.0 taken as +0.0), so their bit patterns order like their values, and
// the low word breaks ties to the larger face id: the order-free rule of
// both versions (max depth, ties to the later draw, wgpu's GreaterEqual),
// so the atomic merge is exact and its result does not depend on the
// order of the units. A covered key is never 0, so 0 marks "no fragment";
// the unpack takes max(key, clear key), which keeps clear_depth and face id
// -1 where nothing reached clear_depth, as the plain version's scatter-amax
// over a clear-filled buffer does.
//
// kChunk = 128 pairs and 256 threads: the shared keys (32 KB for a 4096-px
// sub-rectangle) plus 128 staged rows of 18 fields, face ids and rectangles
// come to 43.5 KB, under the 48 KB of static shared memory. ptxas gives the
// kernel 64 registers and no spills, so four blocks (1,024 threads) are
// resident per SM (shared memory would allow five; more registers would
// cost one).
// Each of the 8 warps takes 16 pairs of a unit, enough to amortise the
// box clear and merge (a unit of a dense tile covers a few 8-row buckets,
// since bins sort by y-bucket), and the smoke frame has 1,657 units for
// 528 resident blocks.
//
// What bounds it on this card: bytes. Each named face's setup fields 0-17
// (72 B) and AABB (16 B) read once, 4 B of face id per pair (203k pairs),
// and a (2, 1088, 1920) f32 output written, against ~0.27 GFLOP of edge
// and depth arithmetic; the key buffer's zeroing, merge and unpack add
// ~50 MB of L2 traffic, and a unit reads its pairs' rows once per pair.
//
// The edge, depth and division expressions are raster.py:151-191 term for
// term and the library is built with --fmad=false, so depth and face id
// equal the plain version's bit for bit.
//
// Slabs (renderer.render_frame's tile_row_offset, parallel.py): row0 is the
// slab's first global tile row. Pixel coordinates, and the clamp of the
// pixel rectangles to the tile, are global (raster.py:353-364), so a slab
// evaluates the same edge arithmetic as the full frame; the unit table, the
// shared key buffer and the output rows stay local to the slab.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;
constexpr int kMaxTilePx = 4096;  // pixels of one sub-rectangle: the shared key buffer
constexpr int kSubW = 128, kSubH = kMaxTilePx / kSubW;  // the sub-rectangle of a tile taller than kSubH
constexpr int kSetupWidth = 24;
constexpr int kRowFields = 18;  // setup fields 0-17: edges, z, w, face id, anchor
constexpr int kUnitsThreads = 1024;
constexpr int kUnpackThreads = 256;
#ifdef TR_HOST_EMU
constexpr int kUnpackMaxBlocks = 4;
#else
constexpr int kUnpackMaxBlocks = 4096;
#endif

__device__ __forceinline__ bool edge_covered(float e, bool on_edge_ok) {
  return (e < 0.0f) || (e == 0.0f && on_edge_ok);
}

// A rectangle's first and last pixel (whole numbers, as floats) relative
// to the tile's first pixel g0, clamped into the tile: the first into
// [0, size], the last into [-1, size - 1] (an empty range when the
// rectangle misses the tile). Inside the tile the bounds are exact.
__device__ __forceinline__ int tile_first(float v, int g0, int size) {
  return (int)fminf(fmaxf(v, (float)g0), (float)(g0 + size)) - g0;
}

__device__ __forceinline__ int tile_last(float v, int g0, int size) {
  return (int)fminf(fmaxf(v, (float)(g0 - 1)), (float)(g0 + size - 1)) - g0;
}

// A tile's sub-rectangles: w x h pixels (the last column and row of them
// may be narrower or shorter), nx x ny of them, numbered row-major.
struct Subs {
  int w, h, nx, ny;
};

__host__ __device__ __forceinline__ Subs tile_subs(int tile_h, int tile_w) {
  Subs s;
  if (tile_h * tile_w <= kMaxTilePx) {
    s.w = tile_w;
    s.h = tile_h;
  } else {  // whole kSubW-column strips of the tile's rows, or kSubW x kSubH
    const int strip = kMaxTilePx / tile_h / kSubW * kSubW;
    s.w = min(tile_w, strip > kSubW ? strip : kSubW);
    s.h = min(tile_h, kMaxTilePx / s.w);
  }
  s.nx = (tile_w + s.w - 1) / s.w;
  s.ny = (tile_h + s.h - 1) / s.h;
  return s;
}

// work[t] = first unit of tile t (units: n_subs * ceil(count / kChunk) per
// tile, unit k of a tile is chunk k / n_subs on sub-rectangle k % n_subs),
// work[n_tiles] = number of units, work[n_tiles + 1] = 0 (the unit
// counter), work[n_tiles + 2 + u] = the tile of unit u.
__global__ void raster_units_kernel(const int* __restrict__ offsets, int n_tiles, int n_subs, int* __restrict__ work,
                                    long long* mark_start) {
  stamp_start(mark_start);
  __shared__ int sums[kUnitsThreads];
  const int per = (n_tiles + kUnitsThreads - 1) / kUnitsThreads;
  const int t0 = threadIdx.x * per;
  const int t1 = min(n_tiles, t0 + per);
  int local = 0;
  for (int t = t0; t < t1; ++t) local += (offsets[t + 1] - offsets[t] + kChunk - 1) / kChunk * n_subs;
  sums[threadIdx.x] = local;
  __syncthreads();
  for (int step = 1; step < kUnitsThreads; step <<= 1) {  // inclusive scan
    const int v = (int)threadIdx.x >= step ? sums[threadIdx.x - step] : 0;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  int acc = sums[threadIdx.x] - local;
  int* unit_tile = work + n_tiles + 2;
  for (int t = t0; t < t1; ++t) {
    work[t] = acc;
    const int units = (offsets[t + 1] - offsets[t] + kChunk - 1) / kChunk * n_subs;
    for (int u = 0; u < units; ++u) unit_tile[acc + u] = t;
    acc += units;
  }
  if (threadIdx.x == kUnitsThreads - 1) {
    work[n_tiles] = sums[kUnitsThreads - 1];
    work[n_tiles + 1] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    raster_kernel(const float* __restrict__ setup, const float* __restrict__ aabb,
                  const int* __restrict__ pair_faces, const int* __restrict__ offsets, int* __restrict__ work,
                  int tiles_x, int n_tiles, int tile_h, int tile_w, Subs subs, int row0,
                  unsigned long long* __restrict__ gkeys) {
  __shared__ unsigned long long keys[kMaxTilePx];
  __shared__ float rows[kChunk][kRowFields];
  __shared__ int faces[kChunk];
  __shared__ short rect[kChunk][4];  // sub-rectangle-local x0, y0, x1, y1 (inclusive)
  __shared__ int box[4];             // union of the unit's rectangles
  __shared__ int unit_tile, unit_p0, unit_n, unit_sub, unit_m;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int width = tiles_x * tile_w;
  const int n_subs = subs.nx * subs.ny;
  const int n_units = work[n_tiles];
  int* counter = work + n_tiles + 1;
  const int* unit_tiles = work + n_tiles + 2;

  for (;;) {
    if (threadIdx.x == 0) {
      const int u = atomicAdd(counter, 1);
      int t = -1;
      if (u < n_units) {
        t = unit_tiles[u];
        const int k = u - work[t];
        unit_p0 = offsets[t] + k / n_subs * kChunk;
        unit_n = min(kChunk, offsets[t + 1] - unit_p0);
        unit_sub = k % n_subs;
      }
      unit_tile = t;
      unit_m = 0;
      box[0] = kMaxTilePx;
      box[1] = kMaxTilePx;
      box[2] = -1;
      box[3] = -1;
    }
    __syncthreads();
    const int t = unit_tile;
    if (t < 0) break;
    const int p0 = unit_p0;
    const int n = unit_n;
    const int sx = unit_sub % subs.nx * subs.w, sy = unit_sub / subs.nx * subs.h;
    const int sw = min(subs.w, tile_w - sx), sh = min(subs.h, tile_h - sy);  // the sub-rectangle's size
    const int gx0 = (t % tiles_x) * tile_w + sx;         // the sub-rectangle's first column
    const int gy0 = (t / tiles_x) * tile_h + sy;         // ... its first row in the output
    const int py0 = (t / tiles_x + row0) * tile_h + sy;  // ... and in the frame (pixel coordinates)

    // The pairs whose rectangle reaches the sub-rectangle, in any order
    // (the merge is order-free): m of them, staged below. Each warp claims
    // its pairs' slots with one shared atomic and folds its rectangles into
    // the union box before one atomic per bound.
    {
      int f = 0, x0 = 0, y0 = 0, x1 = -1, y1 = -1;
      if ((int)threadIdx.x < n) {
        f = pair_faces[p0 + threadIdx.x];
        const float* a = aabb + (long long)f * 4;
        x0 = tile_first(floorf(a[0]) - 1.0f, gx0, sw);
        y0 = tile_first(floorf(a[1]) - 1.0f, py0, sh);
        x1 = tile_last(floorf(a[2]) + 1.0f, gx0, sw);
        y1 = tile_last(floorf(a[3]) + 1.0f, py0, sh);
      }
      const bool hit = x0 <= x1 && y0 <= y1;
      const unsigned mask = warp_ballot(hit);
      const int bx0 = warp_min_i(hit ? x0 : kMaxTilePx), by0 = warp_min_i(hit ? y0 : kMaxTilePx);
      const int bx1 = warp_max_i(hit ? x1 : -1), by1 = warp_max_i(hit ? y1 : -1);
      int first = 0;
      if (lane == 0 && mask != 0u) {
        first = atomicAdd(&unit_m, __popc(mask));
        atomicMin(&box[0], bx0);
        atomicMin(&box[1], by0);
        atomicMax(&box[2], bx1);
        atomicMax(&box[3], by1);
      }
      first = warp_shfl_i(first, 0);
      if (hit) {
        const int j = first + __popc(mask & ((1u << lane) - 1u));
        faces[j] = f;
        rect[j][0] = (short)x0;
        rect[j][1] = (short)y0;
        rect[j][2] = (short)x1;
        rect[j][3] = (short)y1;
      }
    }
    __syncthreads();
    // Every rectangle of the unit may miss the sub-rectangle (a pair binned
    // outside its AABB, or a face in another part of a large tile): m is
    // then 0, and the unit stages, clears, evaluates and merges nothing.
    const int m = unit_m;
    for (int i = threadIdx.x; i < m * kRowFields; i += kThreads) {
      const int j = i / kRowFields;
      rows[j][i % kRowFields] = setup[(long long)faces[j] * kSetupWidth + i % kRowFields];
    }
    const int bx0 = box[0], by0 = box[1];
    const int bw = m == 0 ? 0 : box[2] - bx0 + 1, bh = m == 0 ? 0 : box[3] - by0 + 1;
    for (int i = threadIdx.x; i < bw * bh; i += kThreads) {
      keys[(by0 + i / bw) * sw + bx0 + i % bw] = 0ull;
    }
    __syncthreads();

    for (int j = warp; j < m; j += kWarps) {
      const int x0 = rect[j][0], y0 = rect[j][1];
      const int rw = rect[j][2] - x0 + 1, rh = rect[j][3] - y0 + 1;
      const float* r = rows[j];
      const float a0 = r[0], b0 = r[1], c0e = r[2];
      const float a1 = r[3], b1 = r[4], c1e = r[5];
      const float a2 = r[6], b2 = r[7], c2e = r[8];
      const float z0 = r[9], z1 = r[10], z2 = r[11];
      const float w0 = r[12], w1 = r[13], w2 = r[14];
      const float anc_x = r[16], anc_y = r[17];
      const unsigned fid1 = (unsigned)(faces[j] + 1);
      const bool crossing = (w0 <= 0.0f) || (w1 <= 0.0f) || (w2 <= 0.0f);
      // _edge_covered's on-edge rule for the edge and for its negation.
      const bool ok0 = (a0 < 0.0f) || (a0 == 0.0f && b0 < 0.0f);
      const bool ok1 = (a1 < 0.0f) || (a1 == 0.0f && b1 < 0.0f);
      const bool ok2 = (a2 < 0.0f) || (a2 == 0.0f && b2 < 0.0f);
      const bool nok0 = (a0 > 0.0f) || (a0 == 0.0f && b0 > 0.0f);
      const bool nok1 = (a1 > 0.0f) || (a1 == 0.0f && b1 > 0.0f);
      const bool nok2 = (a2 > 0.0f) || (a2 == 0.0f && b2 > 0.0f);
      for (int i = lane; i < rw * rh; i += 32) {
        const int lx = x0 + i % rw;
        const int ly = y0 + i / rw;
        const float pxr = ((float)(gx0 + lx) + 0.5f) - anc_x;
        const float pyr = ((float)(py0 + ly) + 0.5f) - anc_y;
        const float e0 = pxr * a0 + pyr * b0 + c0e;
        const float e1 = pxr * a1 + pyr * b1 + c1e;
        const float e2 = pxr * a2 + pyr * b2 + c2e;
        const bool cov_n = edge_covered(e0, ok0) && edge_covered(e1, ok1) && edge_covered(e2, ok2);
        const bool cov_p = crossing && edge_covered(-e0, nok0) && edge_covered(-e1, nok1) &&
                           edge_covered(-e2, nok2);
        const float esum = e0 + e1 + e2;
        const float ez = e0 * z0 + e1 * z1 + e2 * z2;
        const float ew = e0 * w0 + e1 * w1 + e2 * w2;
        const bool w_front = (ew * esum) > 0.0f;
        const float z = ez / (ew == 0.0f ? 1e-30f : ew);
        const bool z_ok = (z >= 0.0f) && (z <= 1.0f);
        if ((cov_n || cov_p) && w_front && z_ok) {
          const unsigned zbits = z == 0.0f ? 0u : __float_as_uint(z);  // -0.0 -> +0.0
          atomicMax(&keys[ly * sw + lx], ((unsigned long long)zbits << 32) | fid1);
        }
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < bw * bh; i += kThreads) {
      const int ly = by0 + i / bw;
      const int lx = bx0 + i % bw;
      const unsigned long long k = keys[ly * sw + lx];
      if (k != 0ull) atomicMax(&gkeys[(long long)(gy0 + ly) * width + gx0 + lx], k);
    }
    __syncthreads();  // the unit's shared state is free for the next one
  }
}

__global__ void raster_unpack_kernel(const unsigned long long* __restrict__ gkeys, long long n_px,
                                     unsigned long long clear_key, float* __restrict__ out, long long* mark_end) {
  for (long long i = (long long)blockIdx.x * kUnpackThreads + threadIdx.x; i < n_px;
       i += (long long)gridDim.x * kUnpackThreads) {
    const unsigned long long k = gkeys[i] < clear_key ? clear_key : gkeys[i];
    out[i] = __uint_as_float((unsigned)(k >> 32));
    out[n_px + i] = (float)((int)(unsigned)(k & 0xffffffffull) - 1);
  }
  stamp_end(mark_end);
}

}  // namespace

// pair_slots: the length of pair_faces (the binned pairs are its first
// offsets[n_tiles]); row0: the first global tile row (0 for a whole frame);
// scratch: (Hp * Wp) 64-bit keys; work: work_len ints, at least
// n_tiles + 2 + n_subs * (n_tiles + ceil(pair_slots / 128))
// (kernels/raster.py kernel_buffers). mark_start, mark_end: the frame
// trace's words for raster's start and end, or nullptr (common.cuh).

extern "C" int tr_raster(const float* setup, const float* aabb, const int* pair_faces, const int* offsets,
                         int pair_slots, int tiles_x, int tiles_y, int tile_h, int tile_w, int row0,
                         float clear_depth, void* scratch, int* work, int work_len, float* out,
                         long long* mark_start, long long* mark_end, void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  if (tile_h < 1 || tile_w < 1) return (int)cudaErrorInvalidValue;
  const Subs subs = tile_subs(tile_h, tile_w);
  if (work_len < n_tiles + 2 + (long long)subs.nx * subs.ny * (n_tiles + (pair_slots + kChunk - 1) / kChunk)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_px = (long long)n_tiles * tile_h * tile_w;
  unsigned long long* gkeys = (unsigned long long*)scratch;
  // The units first: the frame trace's raster start is its first block.
  TR_LAUNCH(raster_units_kernel, 1, kUnitsThreads, stream, offsets, n_tiles, subs.nx * subs.ny, work,
            mark_start);
  cudaError_t err = cudaMemsetAsync(gkeys, 0, n_px * sizeof(unsigned long long), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
#ifdef TR_HOST_EMU
  const int grid = 3;
#else
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raster_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int grid = sms * (per_sm > 1 ? per_sm : 1);
#endif
  TR_LAUNCH(raster_kernel, grid, kThreads, stream, setup, aabb, pair_faces, offsets, work, tiles_x, n_tiles,
            tile_h, tile_w, subs, row0, gkeys);
  unsigned clear_bits;
  memcpy(&clear_bits, &clear_depth, 4);
  const unsigned long long clear_key = (unsigned long long)clear_bits << 32;
  const long long px_blocks = (n_px + kUnpackThreads - 1) / kUnpackThreads;
  const int unpack_blocks = px_blocks < kUnpackMaxBlocks ? (int)px_blocks : kUnpackMaxBlocks;
  TR_LAUNCH(raster_unpack_kernel, unpack_blocks, kUnpackThreads, stream, gkeys, n_px, clear_key, out, mark_end);
  return (int)cudaGetLastError();
}

#ifndef TR_HOST_EMU
// The raster kernel's registers per thread and resident blocks per SM.
extern "C" int tr_raster_info(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, raster_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, raster_kernel, kThreads, 0);
}
#endif

extern "C" const char* tr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
