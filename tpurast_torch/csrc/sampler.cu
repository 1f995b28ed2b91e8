// Anisotropic trilinear texturing from the bf16 texture page, basic.frag
// lighting and the framebuffer blend.
//
// Replaces tpurast/kernels/sampler.py::_sampler_kernel (helper
// _slot_accumulate), and for residual tiles the gather fallback the
// reference's renderer overlays (renderer.py:54-173). Plain torch version:
// tpurast_torch/kernels/sampler.py::sample_tiles_plain.
//
// One thread per pixel, one pass: the pixel reads its G-buffer planes once,
// runs its own and parent probe trains, mixes, lights, blends and stores.
// Every texel comes straight from the page through the read-only path and
// L1 / L2; there is no staging, no shared memory and no barrier. The
// reference stages planned windows because its vector unit cannot gather
// per lane; this card can, and its L1 does the windowing, so windowed and
// residual tiles run the same code and the plan (csrc/plan.cu) is read for
// one thing: a tile of class EMPTY gets the clear color without a look at
// the G-buffer. Unmatched pixels take the clear color too.
//
// The page is channel-interleaved, (PH, PW, 4) bf16: a texel is one 8-byte
// load, a tap's x neighbours are 16 adjacent bytes, and a 32-byte sector
// holds 4 whole texels. A block is 32 x 8 pixels in 8 warps of 32 x 1
// pixels (kWarpW x kWarpH): a warp reads one 128-byte line per G-buffer
// plane. Warps of 16 x 2, 8 x 4 and 4 x 8 pixels, whose taps fall in a more
// compact patch of the page but whose G-buffer reads split into 2, 4 and 8
// requests per plane, measured 1.5%, 1.7% and 12% slower on chip_smoke.py's
// 1920x1080 frame, and a channel-planar page (4, PH, PW) 16% slower
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md keeps the table).
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
// What bounds it on this card: texel loads in flight and divergence. A
// pixel makes up to 16 probes x 2 mips x 4 texel loads; one loop iteration
// has the 8 loads of an own and a parent tap in flight together. A warp
// runs to its worst lane's probe count (chip_smoke.py prints the mean of
// that beside the mean per pixel).

#include "shading.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockW = 32, kBlockH = kThreads / kBlockW;  // pixels of a block
constexpr int kWarpW = 32, kWarpH = 32 / kWarpW;  // pixels of a warp
constexpr int kClsEmpty = 2;
static_assert(kBlockW % kWarpW == 0 && kBlockH % kWarpH == 0, "the warps tile the block");

// The (PH, PW, 4) bf16 page; page(py, px, t) reads the four channels of
// the texel at page row py, column px.
struct Page {
  const uint2* __restrict__ texels;
  int page_w;
  __device__ __forceinline__ void operator()(int py, int px, float t[4]) const {
    const uint2 bits = ldg_u2(texels + ((long long)py * page_w + px));
    t[0] = bf16_bits(bits.x & 0xFFFFu);
    t[1] = bf16_bits(bits.x >> 16);
    t[2] = bf16_bits(bits.y & 0xFFFFu);
    t[3] = bf16_bits(bits.y >> 16);
  }
};

// One bilinear tap of probe offset fo at the mip of size (ww, hh) whose
// rect starts at page (base_y, base_x), added to acc.
__device__ __forceinline__ void tap(const Page& page, float u, float v, float maj_du, float maj_dv, float fo,
                                    float ww, float hh, float ww_c, float hh_c, float base_y, float base_x,
                                    float acc[4]) {
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
  float t00[4], t01[4], t10[4], t11[4];
  page(py, px, t00);
  page(py, px + 1, t01);
  page(py + 1, px, t10);
  page(py + 1, px + 1, t11);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float row0 = t00[c] * cw0 + t01[c] * cw1;
    const float row1 = t10[c] * cw0 + t11[c] * cw1;
    acc[c] = acc[c] + (row0 * ry0 + row1 * ry1);
  }
}

// Mip blend and probe normalisation of one matched pixel
// (sampler.py:867-880), then shading.cuh's lighting and blend.
__device__ void shade_store(const float* __restrict__ gbuf, long long plane, long long p, const float s_own[4],
                            const float s_par[4], float n_px, const float* __restrict__ cam,
                            const ShadeParams& prm, float* __restrict__ out) {
  float g[6];
  for (int i = 0; i < 6; ++i) g[i] = gbuf[i * plane + p];
  const float tfrac = gbuf[13 * plane + p];
  const float t_i = 1.0f - tfrac;
  float albedo[4];
  for (int c = 0; c < 4; ++c) albedo[c] = (s_own[c] * t_i + s_par[c] * tfrac) / n_px;
  light_store(g, albedo, cam, prm, plane, p, out);
}

__device__ __forceinline__ void sample_pixel(const float* __restrict__ gbuf, Page page, const int* __restrict__ table,
                                             const float* __restrict__ cam, int tiles_x, int tile_h, int tile_w, int hp,
                                             int wp, int max_anisotropy, const ShadeParams& prm,
                                             float* __restrict__ out) {
  // A warp's lanes cover kWarpW x kWarpH pixels; the warps tile the block.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * kBlockW + warp % (kBlockW / kWarpW) * kWarpW + lane % kWarpW;
  const int y = blockIdx.y * kBlockH + warp / (kBlockW / kWarpW) * kWarpH + lane / kWarpW;
  if (x >= wp || y >= hp) return;
  const long long plane = (long long)hp * wp;
  const long long p = (long long)y * wp + x;
  const int cls = table[((long long)(y / tile_h) * tiles_x + x / tile_w) * 8 * 128];
  if (cls == kClsEmpty || !(gbuf[16 * plane + p] > 0.0f)) {
    store_clear(prm, plane, p, out);
    return;
  }
  const float u = gbuf[6 * plane + p], v = gbuf[7 * plane + p];
  const float maj_du = gbuf[14 * plane + p], maj_dv = gbuf[15 * plane + p], span = gbuf[17 * plane + p];
  const float tw0 = gbuf[9 * plane + p], th0 = gbuf[10 * plane + p];
  const float tw1 = gbuf[11 * plane + p], th1 = gbuf[12 * plane + p];
  const float by0 = gbuf[20 * plane + p], bx0 = gbuf[21 * plane + p];
  const float by1 = gbuf[22 * plane + p], bx1 = gbuf[23 * plane + p];
  const float tw0_c = max_nan(tw0, 1.0f), th0_c = max_nan(th0, 1.0f);
  const float tw1_c = max_nan(tw1, 1.0f), th1_c = max_nan(th1, 1.0f);
  const float n_px = probe_count(maj_du, maj_dv, tw0, th0, span, max_anisotropy);
  float s_own[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s_par[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; (float)i < n_px; ++i) {
    const float fo = (((float)i + 0.5f) / n_px - 0.5f) * span;
    tap(page, u, v, maj_du, maj_dv, fo, tw0, th0, tw0_c, th0_c, by0, bx0, s_own);
    tap(page, u, v, maj_du, maj_dv, fo, tw1, th1, tw1_c, th1_c, by1, bx1, s_par);
  }
  shade_store(gbuf, plane, p, s_own, s_par, n_px, cam, prm, out);
}

__global__ void __launch_bounds__(kThreads)
    sample_kernel(const float* __restrict__ gbuf, Page page, const int* __restrict__ table,
                  const float* __restrict__ cam, int tiles_x, int tile_h, int tile_w, int hp, int wp,
                  int max_anisotropy, ShadeParams prm, float* __restrict__ out, long long* mark_start,
                  long long* mark_end) {
  stamp_start(mark_start);
  sample_pixel(gbuf, page, table, cam, tiles_x, tile_h, tile_w, hp, wp, max_anisotropy, prm, out);
  stamp_end(mark_end);
}

}  // namespace

// page: (PH, PW, 4) bf16, PW = page_w. mark_start, mark_end: the frame
// trace's words for the kernel's start and end, or nullptr (common.cuh).
extern "C" int tr_sample(const float* gbuf, const void* page, int page_w, const int* table, const float* cam,
                         int tiles_x, int tiles_y, int tile_h, int tile_w, int max_anisotropy, const float* params,
                         float* out, long long* mark_start, long long* mark_end, void* stream) {
  const ShadeParams prm = read_shade_params(params);
  const int hp = tiles_y * tile_h, wp = tiles_x * tile_w;
  const dim3 grid((wp + kBlockW - 1) / kBlockW, (hp + kBlockH - 1) / kBlockH);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const Page texels{(const uint2*)page, page_w};
  TR_LAUNCH(sample_kernel, grid, kThreads, stream, gbuf, texels, table, cam, tiles_x, tile_h, tile_w, hp, wp,
            max_anisotropy, prm, out, mark_start, mark_end);
  return (int)cudaGetLastError();
}

#ifndef TR_HOST_EMU
// The sample kernel's registers per thread and resident blocks per SM.
extern "C" int tr_sample_info(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, sample_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sample_kernel, kThreads, 0);
}
#endif
