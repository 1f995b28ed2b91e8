// Forward attribute resolve: the per-pixel G-buffer of the winning face.
//
// Replaces tpurast/kernels/resolve.py::_resolve_kernel, which selects each
// pixel's attribute row with a one-hot matmul per (tile, segment) and then
// interpolates on (tile_h, tile_w) planes. Plain torch version:
// tpurast_torch/kernels/resolve.py::resolve_gbuffer_plain.
//
// One thread per pixel. It reads its face id from the raster output; with
// no face it writes 24 zeros. Otherwise it reads the 89-float row
// attrs[fid] directly (the reference's HIGHEST-precision one-hot matmul is
// an exact selection, so this is the same value) and repeats
// resolve.py:176-281 term for term. The 16-level masked sums become one
// indexed read of the level's column, guarded by the same [0, 16) range.
//
// What bounds it on this card: bytes. Per covered pixel it reads ~100 B of
// the attribute row (neighbouring pixels mostly share a face, so much of
// it hits L1/L2) and writes 96 B of G-buffer planes, every pixel of the
// frame included. The ~150 flops and one log2f per pixel are far below the
// f32 rate. Stores are coalesced: one
// plane at a time, consecutive threads on consecutive pixels.
//
// Slabs: y_offset is the slab's first global pixel row. It is added to the
// local row as an integer before the float conversion, so a slab's pixel
// centers are the full frame's (resolve.py:145, :178-179; integers and
// their halves are exact in f32 at these magnitudes).

#include "common.cuh"

namespace {

constexpr int kAIn = 89;
constexpr int kAOut = 24;
constexpr int kMaxMips = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float level_value(const float* s, int base, float level) {
  return (level >= 0.0f && level < (float)kMaxMips) ? s[base + (int)level] : 0.0f;
}

__device__ __forceinline__ float level_pow(float level) {
  return (level >= 0.0f && level < (float)kMaxMips) ? ldexpf(1.0f, -(int)level) : 0.0f;
}

__device__ __forceinline__ void resolve_pixel(const float* __restrict__ vis, const float* __restrict__ attrs,
                                              int n_faces, int height, int width, int y_offset, int max_anisotropy,
                                              float* __restrict__ out) {
  const long long plane = (long long)height * width;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const float fidf = vis[plane + p];
  const int fid = (int)fidf;
  if (!(fidf >= 0.0f) || fid >= n_faces) {
    for (int i = 0; i < kAOut; ++i) out[i * plane + p] = 0.0f;
    return;
  }
  const float* s = attrs + (long long)fid * kAIn;
  const float px = ((float)(p % width) + 0.5f) - s[9];
  const float py = ((float)(p / width + y_offset) + 0.5f) - s[10];

  const float e0 = s[0] * px + s[1] * py + s[2];
  const float e1 = s[3] * px + s[4] * py + s[5];
  const float e2 = s[6] * px + s[7] * py + s[8];
  const float esum = e0 + e1 + e2;
  const float eps = 1e-30f;
  const float den = fabsf(esum) < eps ? (esum < 0.0f ? -eps : eps) : esum;
  const float inv = 1.0f / den;
  const float u0 = e0 * inv, u1 = e1 * inv, u2 = e2 * inv;
#define INTERP(b0, b1, b2) (u0 * s[b0] + u1 * s[b1] + u2 * s[b2])
  const float uv_u = INTERP(12, 14, 16), uv_v = INTERP(13, 15, 17);
  const float wx = INTERP(18, 21, 24), wy = INTERP(19, 22, 25), wz = INTERP(20, 23, 26);
  const float nx = INTERP(27, 30, 33), ny = INTERP(28, 31, 34), nz = INTERP(29, 32, 35);
#undef INTERP

  const float d_x = s[0] + s[3] + s[6];
  const float d_y = s[1] + s[4] + s[7];
  const float inv2 = inv * inv;
  float du_dx, du_dy, dv_dx, dv_dy;
  {
    const float nval = e0 * s[12] + e1 * s[14] + e2 * s[16];
    const float gx = s[0] * s[12] + s[3] * s[14] + s[6] * s[16];
    const float gy = s[1] * s[12] + s[4] * s[14] + s[7] * s[16];
    du_dx = (gx * esum - nval * d_x) * inv2;
    du_dy = (gy * esum - nval * d_y) * inv2;
  }
  {
    const float nval = e0 * s[13] + e1 * s[15] + e2 * s[17];
    const float gx = s[0] * s[13] + s[3] * s[15] + s[6] * s[17];
    const float gy = s[1] * s[13] + s[4] * s[15] + s[7] * s[17];
    dv_dx = (gx * esum - nval * d_x) * inv2;
    dv_dy = (gy * esum - nval * d_y) * inv2;
  }

  const float w0 = s[52], h0 = s[53], n_mips = s[54];
  const float ax = du_dx * w0, bx = dv_dx * h0;
  const float ay = du_dy * w0, by = dv_dy * h0;
  const float rho2_x = ax * ax + bx * bx;
  const float rho2_y = ay * ay + by * by;
  float rho2, maj_du, maj_dv, span;
  if (max_anisotropy > 1) {
    // shade.aniso_footprint
    const float rho2_max = max_nan(rho2_x, rho2_y);
    const float rho2_min = min_nan(rho2_x, rho2_y);
    const float inv_n2 = (float)(1.0 / ((double)max_anisotropy * max_anisotropy));
    rho2 = max_nan(rho2_min, rho2_max * inv_n2);
    const float ratio = sqrtf(rho2_max / max_nan(rho2, 1e-24f));
    const float ratio_c = min_nan(max_nan(ratio, 1.0f), (float)max_anisotropy);
    span = 1.0f - 1.0f / ratio_c;
    const bool major_is_x = rho2_x >= rho2_y;
    maj_du = major_is_x ? du_dx : du_dy;
    maj_dv = major_is_x ? dv_dx : dv_dy;
  } else {
    rho2 = max_nan(rho2_x, rho2_y);
    maj_du = 0.0f;
    maj_dv = 0.0f;
    span = 0.0f;
  }

  float lod = 0.5f * log2f(max_nan(rho2, 1e-24f));
  lod = min_nan(max_nan(lod, 0.0f), n_mips - 1.0f);
  const float l0 = floorf(lod);
  const float l1 = min_nan(l0 + 1.0f, n_mips - 1.0f);
  const float tfrac = lod - l0;
  const float pow0 = level_pow(l0);
  const float pow1 = level_pow(l1);

  const float g[kAOut] = {
      wx, wy, wz, nx, ny, nz, uv_u, uv_v,
      level_value(s, 36, l0),
      max_nan(floorf(w0 * pow0), 1.0f),
      max_nan(floorf(h0 * pow0), 1.0f),
      max_nan(floorf(w0 * pow1), 1.0f),
      max_nan(floorf(h0 * pow1), 1.0f),
      tfrac, maj_du, maj_dv, s[55], span, s[56], l0,
      level_value(s, 57, l0), level_value(s, 73, l0),
      level_value(s, 57, l1), level_value(s, 73, l1),
  };
#pragma unroll
  for (int i = 0; i < kAOut; ++i) out[i * plane + p] = g[i];
}

__global__ void resolve_kernel(const float* __restrict__ vis, const float* __restrict__ attrs, int n_faces,
                               int height, int width, int y_offset, int max_anisotropy, float* __restrict__ out,
                               long long* mark_start, long long* mark_end) {
  stamp_start(mark_start);
  resolve_pixel(vis, attrs, n_faces, height, width, y_offset, max_anisotropy, out);
  stamp_end(mark_end);
}

}  // namespace

extern "C" int tr_resolve(const float* vis, const float* attrs, int n_faces, int height, int width,
                          int y_offset, int max_anisotropy, float* out, long long* mark_start, long long* mark_end,
                          void* stream) {
  const long long n = (long long)height * width;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  TR_LAUNCH(resolve_kernel, blocks, kThreads, stream, vis, attrs, n_faces, height, width, y_offset,
            max_anisotropy, out, mark_start, mark_end);
  return (int)cudaGetLastError();
}
