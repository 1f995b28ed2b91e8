// Visibility raster: depth and winning face id per pixel.
//
// Replaces tpurast/kernels/raster.py::_raster_kernel (a Pallas kernel over
// (tile, 128-triangle segment) grid steps). Plain torch version:
// tpurast_torch/kernels/raster.py::rasterize_tiles_plain.
//
// One block per framebuffer tile, 256 threads holding 16 pixels each in
// registers (best depth and face id), so the tile is written exactly once.
// The block walks its tile's whole pair range [offsets[t], offsets[t+1])
// of the binned pair list in chunks of 128 faces, staging their 24-float
// setup rows in shared memory (12 KB): every thread then reads each row as
// a broadcast. There is no segment schedule and nothing is dropped.
//
// What bounds it on this card: f32 issue. Each (pair, pixel) costs ~40
// flops of edge functions and depth, evaluated at every pixel of the tile
// (no row-group restriction yet), while device memory only sees the setup
// rows (96 B per pair) and one (2, 32, 128) tile store. Later work: skip
// pixels outside a face's bounding rows, and split dense tiles over
// several blocks.
//
// The merge rule is order-free: max depth, ties to the max face id (the
// later draw, wgpu's GreaterEqual). The expressions are raster.py:151-191
// term for term.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPxPerThread = 16;
constexpr int kChunk = 128;
constexpr int kSetupWidth = 24;

__device__ __forceinline__ bool edge_covered(float e, bool on_edge_ok) {
  return (e < 0.0f) || (e == 0.0f && on_edge_ok);
}

__global__ void raster_kernel(const float* __restrict__ setup, const int* __restrict__ pair_faces,
                              const int* __restrict__ offsets, int tiles_x, int tiles_y, int tile_h,
                              int tile_w, float clear_depth, float* __restrict__ out) {
  __shared__ float rows[kChunk][kSetupWidth];
  __shared__ int faces[kChunk];

  const int t = blockIdx.x;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const int tile_px = tile_h * tile_w;
  const int width = tiles_x * tile_w;
  const int height = tiles_y * tile_h;

  float best_z[kPxPerThread];
  int best_f[kPxPerThread];
  float pxs[kPxPerThread];  // pixel centers, global framebuffer coordinates
  float pys[kPxPerThread];
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    best_z[k] = clear_depth;
    best_f[k] = -1;
    pxs[k] = (float)(tx * tile_w + p % tile_w) + 0.5f;
    pys[k] = (float)(ty * tile_h + p / tile_w) + 0.5f;
  }

  const int start = offsets[t];
  const int end = offsets[t + 1];
  for (int c0 = start; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    __syncthreads();  // the previous chunk's rows are no longer read
    for (int i = threadIdx.x; i < n * kSetupWidth; i += kThreads) {
      const int j = i / kSetupWidth;
      const int f = pair_faces[c0 + j];
      rows[j][i % kSetupWidth] = setup[(long long)f * kSetupWidth + i % kSetupWidth];
      if (i % kSetupWidth == 0) faces[j] = f;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* r = rows[j];
      const float a0 = r[0], b0 = r[1], c0e = r[2];
      const float a1 = r[3], b1 = r[4], c1e = r[5];
      const float a2 = r[6], b2 = r[7], c2e = r[8];
      const float z0 = r[9], z1 = r[10], z2 = r[11];
      const float w0 = r[12], w1 = r[13], w2 = r[14];
      const float anc_x = r[16], anc_y = r[17];
      const int fid = faces[j];
      const bool crossing = (w0 <= 0.0f) || (w1 <= 0.0f) || (w2 <= 0.0f);
      // _edge_covered's on-edge rule for the edge and for its negation.
      const bool ok0 = (a0 < 0.0f) || (a0 == 0.0f && b0 < 0.0f);
      const bool ok1 = (a1 < 0.0f) || (a1 == 0.0f && b1 < 0.0f);
      const bool ok2 = (a2 < 0.0f) || (a2 == 0.0f && b2 < 0.0f);
      const bool nok0 = (a0 > 0.0f) || (a0 == 0.0f && b0 > 0.0f);
      const bool nok1 = (a1 > 0.0f) || (a1 == 0.0f && b1 > 0.0f);
      const bool nok2 = (a2 > 0.0f) || (a2 == 0.0f && b2 > 0.0f);
#pragma unroll
      for (int k = 0; k < kPxPerThread; ++k) {
        if (threadIdx.x + k * kThreads >= tile_px) break;
        const float pxr = pxs[k] - anc_x;
        const float pyr = pys[k] - anc_y;
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
        if ((cov_n || cov_p) && w_front && z_ok &&
            (z > best_z[k] || (z == best_z[k] && fid > best_f[k]))) {
          best_z[k] = z;
          best_f[k] = fid;
        }
      }
    }
  }

  const long long plane = (long long)width * height;
#pragma unroll
  for (int k = 0; k < kPxPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p >= tile_px) break;
    const long long o = (long long)(ty * tile_h + p / tile_w) * width + tx * tile_w + p % tile_w;
    out[o] = best_z[k];
    out[plane + o] = (float)best_f[k];
  }
}

}  // namespace

extern "C" int tr_raster(const float* setup, const int* pair_faces, const int* offsets, int tiles_x,
                         int tiles_y, int tile_h, int tile_w, float clear_depth, float* out,
                         void* stream) {
  if (tile_h * tile_w > kThreads * kPxPerThread) return (int)cudaErrorInvalidValue;
  TR_LAUNCH(raster_kernel, tiles_x * tiles_y, kThreads, stream, setup, pair_faces, offsets,
            tiles_x, tiles_y, tile_h, tile_w, clear_depth, out);
  return (int)cudaGetLastError();
}

extern "C" const char* tr_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
