// Anisotropic trilinear texturing from the bf16 texture page through the
// per-tile window plan, basic.frag lighting and the framebuffer blend.
//
// Replaces tpurast/kernels/sampler.py::_sampler_kernel (helper
// _slot_accumulate), and for residual tiles the gather fallback the
// reference's renderer overlays (renderer.py:54-173). Plain torch version:
// tpurast_torch/kernels/sampler.py::sample_tiles_plain.
//
// One block per (tile, chunk of rc rows), 256 threads x 8 pixels. The
// plan (csrc/plan.cu) gives the tile's class, its window origins, each
// pixel's own and parent slot, and per (chunk, slot) the y and x bands of
// the window that the chunk's pixels touch. For a windowed tile the block
// walks its chunk's live slots and stages each slot's planned region
// (nyb*YB x nxb*XB texels) in 48 KB of shared memory, all four channels
// when they fit, else one or two at a time, then every pixel whose own
// or parent role uses the slot sums that role's probes, reading a texel
// from the staged region when the region holds it and from the page
// otherwise (sampler.py:550-647, 705-880, with shared memory in place of
// the VMEM window DMAs). Residual tiles read every texel from the page
// (the port's counterpart of the reference's gather fallback); empty
// tiles and unmatched pixels take the clear color. Where a texel is read
// from never changes the sum, so the frame equals direct sampling bit for
// bit, whatever the plan.
//
// Per pixel: n = probe_count(...) <= 16 probes along the footprint's
// major axis; each probe is one bilinear tap at the own mip and one at
// the parent mip, at the wrapped texel x0w = x0 mod w whose +1 neighbours
// lie in the rect's ghost border (device/pages.py). Weights follow the
// reference's arithmetic (sampler.py:613-642): x weights rounded to bf16
// like its matmul operand, y weights f32, a tap is
// sum_y ry * (sum_x cw * t). The sums mix as ((1 - tf) * S_own +
// tf * S_par) / n (sampler.py:870-880).
//
// What bounds it on this card: texel reads and the per-slot staging. A
// pixel makes up to 16 probes x 2 mips x 4 texels x 4 channels reads;
// staged ones come from shared memory. A region is loaded once per
// (chunk, slot) when its four channels fit (one band: 48 KB), and every
// pass over it recomputes the pixels' probe positions; the loop that
// stages a region is unrolled so that a thread has 8 page loads in
// flight. Later work: vector loads for the staging, channel-interleaved
// texels, and staging only where it beats the L1/L2 hits of direct reads.

#include "common.cuh"

namespace {

constexpr int kAOut = 24;
constexpr int kThreads = 256;
constexpr int kPPT = 8;  // pixels per thread
constexpr int kYB = 48, kXB = 128;
constexpr int kStage = 24576;  // staged bf16 texels per block (48 KB)
constexpr int kClsWindowed = 0, kClsResidual = 3;

struct ShadeParams {
  float light_direction[3];
  float light_color[3];
  float ambient;
  float specular_power;
  float clear[4];
  float opaque;
};

// A texel of channel c at page row py, column px, from the page.
struct PageFetch {
  const __nv_bfloat16* __restrict__ page;
  long long plane;
  int page_w;
  __device__ __forceinline__ float operator()(int c, int py, int px) const {
    return __bfloat162float(page[c * plane + (long long)py * page_w + px]);
  }
};

// The same texel from the staged region (channels c0.., rows y0.. h,
// columns x0.. w) when it holds it, else from the page.
struct StageFetch {
  const __nv_bfloat16* stage;
  int c0, y0, x0, h, w;
  PageFetch page;
  __device__ __forceinline__ float operator()(int c, int py, int px) const {
    const int dy = py - y0, dx = px - x0;
    if (dy >= 0 && dy < h && dx >= 0 && dx < w) return __bfloat162float(stage[((c - c0) * h + dy) * w + dx]);
    return page(c, py, px);
  }
};

// Probe sum of one mip level into acc[c] for channels c0 <= c < c0 + nch.
template <class Fetch>
__device__ __forceinline__ void tap_sum(const Fetch& fetch, int c0, int nch, float u, float v, float maj_du,
                                        float maj_dv, float span, float n_px, float ww, float hh, float base_y,
                                        float base_x, float acc[4]) {
  const float ww_c = max_nan(ww, 1.0f);
  const float hh_c = max_nan(hh, 1.0f);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c >= c0 && c < c0 + nch) acc[c] = 0.0f;
  for (int i = 0; (float)i < n_px; ++i) {
    const float fo = (((float)i + 0.5f) / n_px - 0.5f) * span;
    const float x = (u + maj_du * fo) * ww - 0.5f;
    const float y = (v + maj_dv * fo) * hh - 0.5f;
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float fx = x - x0;
    const float fy = y - y0;
    const int px = (int)(base_x + floor_mod(x0, ww_c));
    const int py = (int)(base_y + floor_mod(y0, hh_c));
    const float cw1 = round_bf16(fx);
    const float cw0 = round_bf16(1.0f - fx);
    const float ry0 = 1.0f - fy;
    const float ry1 = fy;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < c0 || c >= c0 + nch) continue;
      const float row0 = fetch(c, py, px) * cw0 + fetch(c, py, px + 1) * cw1;
      const float row1 = fetch(c, py + 1, px) * cw0 + fetch(c, py + 1, px + 1) * cw1;
      acc[c] = acc[c] + (row0 * ry0 + row1 * ry1);
    }
  }
}

__device__ __forceinline__ float rnorm3(float x, float y, float z) {
  return 1.0f / sqrtf(max_nan(x * x + y * y + z * z, 1e-20f));
}

// Mip blend, probe normalisation, lighting and blend of one matched pixel
// (sampler.py:867-880 and shade_out).
__device__ void shade_store(const float* __restrict__ gbuf, long long plane, long long p, const float s_own[4],
                            const float s_par[4], float n_px, const float* __restrict__ cam,
                            const ShadeParams& prm, float* __restrict__ out) {
  float g[6];
  for (int i = 0; i < 6; ++i) g[i] = gbuf[i * plane + p];
  const float tfrac = gbuf[13 * plane + p];
  const float t_i = 1.0f - tfrac;
  float albedo[4];
  for (int c = 0; c < 4; ++c) albedo[c] = (s_own[c] * t_i + s_par[c] * tfrac) / n_px;

  // shade._light_planes (basic.frag:15-38)
  const float ldx = prm.light_direction[0], ldy = prm.light_direction[1],
              ldz = prm.light_direction[2];
  const float rn = rnorm3(g[3], g[4], g[5]);
  const float nx = g[3] * rn, ny = g[4] * rn, nz = g[5] * rn;
  float vx = cam[0] - g[0], vy = cam[1] - g[1], vz = cam[2] - g[2];
  const float rv = rnorm3(vx, vy, vz);
  vx = vx * rv;
  vy = vy * rv;
  vz = vz * rv;
  const float n_dot_l = nx * ldx + ny * ldy + nz * ldz;
  const float diffuse = max_nan(n_dot_l, 0.0f);
  const float rx = 2.0f * n_dot_l * nx - ldx;
  const float ry = 2.0f * n_dot_l * ny - ldy;
  const float rz = 2.0f * n_dot_l * nz - ldz;
  const float v_dot_r = max_nan(vx * rx + vy * ry + vz * rz, 0.0f);
  const float spec = albedo[3] * powf(v_dot_r, prm.specular_power);
  const float k = prm.ambient + diffuse;
  for (int c = 0; c < 3; ++c) {
    const float rgb = (k * prm.light_color[c]) * albedo[c] + spec * prm.light_color[c];
    // shade.blend_planes with source alpha 1: rgb * 1 + clear * 0.
    out[c * plane + p] = prm.opaque != 0.0f ? rgb : rgb * 1.0f + 0.0f;
  }
  out[3 * plane + p] = prm.opaque != 0.0f ? 1.0f : prm.clear[3];
}

__device__ __forceinline__ float probe_count(const float* __restrict__ gbuf, long long plane, long long p,
                                             int max_anisotropy) {
  if (max_anisotropy <= 1) return 1.0f;
  // shade.probe_count
  const float ext = max_nan(fabsf(gbuf[14 * plane + p]) * gbuf[9 * plane + p],
                            fabsf(gbuf[15 * plane + p]) * gbuf[10 * plane + p]) *
                    gbuf[17 * plane + p];
  return min_nan(max_nan(ceilf(ext - 1e-4f), 1.0f), (float)max_anisotropy);
}

// Residual tiles: every texel straight from the page.
__device__ void sample_direct(const float* __restrict__ gbuf, long long plane, long long p,
                              const __nv_bfloat16* __restrict__ page, int page_h, int page_w,
                              const float* __restrict__ cam, int max_anisotropy, const ShadeParams& prm,
                              float* __restrict__ out) {
  float g[kAOut];
#pragma unroll
  for (int i = 0; i < kAOut; ++i) g[i] = gbuf[i * plane + p];
  const float n_px = probe_count(gbuf, plane, p, max_anisotropy);
  const PageFetch fetch{page, (long long)page_h * page_w, page_w};
  float s_own[4], s_par[4];
  tap_sum(fetch, 0, 4, g[6], g[7], g[14], g[15], g[17], n_px, g[9], g[10], g[20], g[21], s_own);
  tap_sum(fetch, 0, 4, g[6], g[7], g[14], g[15], g[17], n_px, g[11], g[12], g[22], g[23], s_par);
  shade_store(gbuf, plane, p, s_own, s_par, n_px, cam, prm, out);
}

__global__ void sample_kernel(const float* __restrict__ gbuf, const __nv_bfloat16* __restrict__ page,
                              int page_h, int page_w, const int* __restrict__ table,
                              const float* __restrict__ assign, const float* __restrict__ cam, int tiles_x,
                              int tiles_y, int tile_h, int tile_w, int rc, int max_anisotropy,
                              ShadeParams prm, float* __restrict__ out) {
  __shared__ __nv_bfloat16 stage[kStage];
  const int tid = threadIdx.x;
  const int nc = tile_h / rc;
  const int t = blockIdx.x / nc, ci = blockIdx.x % nc;
  const int wp = tiles_x * tile_w;
  const long long plane = (long long)tiles_y * tile_h * wp;
  const int cpx = rc * tile_w;
  const int y0 = (t / tiles_x) * tile_h + ci * rc, x0 = (t % tiles_x) * tile_w;
  const int* meta = table + (long long)t * 8 * 128;
  const int* words = meta + (1 + ci) * 128;
  const int cls = meta[0];

  if (cls != kClsWindowed) {
    for (int k = 0; k < kPPT; ++k) {
      const int q = tid + k * kThreads;
      if (q >= cpx) continue;
      const long long p = (long long)(y0 + q / tile_w) * wp + x0 + q % tile_w;
      if (cls == kClsResidual && gbuf[16 * plane + p] > 0.0f) {
        sample_direct(gbuf, plane, p, page, page_h, page_w, cam, max_anisotropy, prm, out);
      } else {
        for (int c = 0; c < 4; ++c) out[c * plane + p] = prm.clear[c];
      }
    }
    return;
  }

  float s_own[kPPT][4], s_par[kPPT][4];
#pragma unroll
  for (int k = 0; k < kPPT; ++k)
    for (int c = 0; c < 4; ++c) s_own[k][c] = s_par[k][c] = 0.0f;
  const PageFetch page_fetch{page, (long long)page_h * page_w, page_w};
  const int n_used = meta[1];
  for (int j = 0; j < n_used; ++j) {
    const int word = words[j];
    if (!(word & 1)) continue;
    // The slot's planned region: rows [b0, b0 + nyb*YB) and columns
    // [xb0*XB, (xb0 + nxb)*XB) of the window at page (oy, ox).
    const int ry0 = meta[32 + j] + ((word >> 1) & 0xFF);
    const int rx0 = meta[64 + j] + ((word >> 12) & 0x3) * kXB;
    const int rh = ((word >> 9) & 0x7) * kYB, rw = ((word >> 14) & 0x3) * kXB;
    const int fit = rh * rw > 0 ? kStage / (rh * rw) : 0;  // channels the stage holds
    const int step = fit >= 4 || fit == 0 ? 4 : (fit >= 2 ? 2 : 1);
    const float jf = (float)j;
    for (int c0 = 0; c0 < 4; c0 += step) {
      const StageFetch fetch{stage, c0, ry0, rx0, rh, fit > 0 ? rw : 0, page_fetch};
      if (fit > 0) {
        __syncthreads();  // the previous pass's readers are done
#pragma unroll 8
        for (int i = tid; i < step * rh * rw; i += kThreads) {
          const int c = c0 + i / (rh * rw), r = i / rw % rh, col = i % rw;
          const int py = ry0 + r, px = rx0 + col;
          stage[i] = py < page_h && px < page_w ? page[c * page_fetch.plane + (long long)py * page_w + px]
                                                : __float2bfloat16(0.0f);
        }
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int q = tid + k * kThreads;
        if (q >= cpx) continue;
        const long long p = (long long)(y0 + q / tile_w) * wp + x0 + q % tile_w;
        const bool own_j = assign[p] == jf, par_j = assign[plane + p] == jf;
        if (!(own_j || par_j)) continue;
        const float u = gbuf[6 * plane + p], v = gbuf[7 * plane + p];
        const float maj_du = gbuf[14 * plane + p], maj_dv = gbuf[15 * plane + p], span = gbuf[17 * plane + p];
        const float n_px = probe_count(gbuf, plane, p, max_anisotropy);
        if (own_j)
          tap_sum(fetch, c0, step, u, v, maj_du, maj_dv, span, n_px, gbuf[9 * plane + p], gbuf[10 * plane + p],
                  gbuf[20 * plane + p], gbuf[21 * plane + p], s_own[k]);
        if (par_j)
          tap_sum(fetch, c0, step, u, v, maj_du, maj_dv, span, n_px, gbuf[11 * plane + p], gbuf[12 * plane + p],
                  gbuf[22 * plane + p], gbuf[23 * plane + p], s_par[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int q = tid + k * kThreads;
    if (q >= cpx) continue;
    const long long p = (long long)(y0 + q / tile_w) * wp + x0 + q % tile_w;
    if (gbuf[16 * plane + p] > 0.0f) {
      shade_store(gbuf, plane, p, s_own[k], s_par[k], probe_count(gbuf, plane, p, max_anisotropy), cam, prm,
                  out);
    } else {
      for (int c = 0; c < 4; ++c) out[c * plane + p] = prm.clear[c];
    }
  }
}

}  // namespace

extern "C" int tr_sample(const float* gbuf, const void* page, int page_h, int page_w, const int* table,
                         const float* assign, const float* cam, int tiles_x, int tiles_y, int tile_h,
                         int tile_w, int rc, int max_anisotropy, const float* params, float* out,
                         void* stream) {
  if (rc * tile_w > kThreads * kPPT || tile_h % rc != 0) return (int)cudaErrorInvalidValue;
  ShadeParams prm;
  const float* q = params;
  for (int i = 0; i < 3; ++i) prm.light_direction[i] = *q++;
  for (int i = 0; i < 3; ++i) prm.light_color[i] = *q++;
  prm.ambient = *q++;
  prm.specular_power = *q++;
  for (int i = 0; i < 4; ++i) prm.clear[i] = *q++;
  prm.opaque = *q++;
  const int blocks = tiles_x * tiles_y * (tile_h / rc);
  TR_LAUNCH(sample_kernel, blocks, kThreads, stream, gbuf, (const __nv_bfloat16*)page, page_h, page_w, table,
            assign, cam, tiles_x, tiles_y, tile_h, tile_w, rc, max_anisotropy, prm, out);
  return (int)cudaGetLastError();
}
