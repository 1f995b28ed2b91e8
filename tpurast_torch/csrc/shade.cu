// The row-atlas shading paths: the forward path's gather tail
// (tr_shade_gbuffer) and deferred shading (tr_shade_deferred).
//
// Replace tpurast/kernels/shade.py::shade_gbuffer and ::shade_deferred
// (with _trilerp, aniso_footprint, probe_count, _light_planes and
// blend_planes). The reference leaves both to XLA and shapes them around
// the TPU: fat-row gathers, because XLA:TPU pays per gathered row;
// channel-planar (C, H, W) arrays; and a static probe loop that runs all
// max_anisotropy probes over every pixel of the frame, masking the ones a
// pixel does not count, since XLA cannot give each pixel its own trip
// count. Plain torch versions: tpurast_torch/kernels/shade.py
// (shade_gbuffer_plain, shade_deferred_plain), which keep that form.
//
// Here one thread shades one pixel, in pixel order (consecutive threads on
// consecutive pixels of a row, so every plane read and store is
// coalesced), and builds nothing per frame:
//   * a pixel with no face reads its match plane (gather) or its face id
//     (deferred) and writes the clear color;
//   * a covered pixel counts its probes (shade.probe_count) and runs only
//     those, not max_anisotropy: each probe is one trilerp from one
//     52-channel atlas row (the own mip's 2x2 quad and the parent mip's
//     3x3 window, device/textures.py), summed in the plain version's order
//     (acc + probe, the mip blend inside each probe) and divided by the
//     count; then shading.cuh's lighting and blend;
//   * the deferred kernel reads the pixel's face row (104 floats of
//     pack_shade_rows; neighbouring pixels share a face, so most of it
//     comes from L1 / L2) and repeats shade_deferred's edge functions,
//     interpolation, UV derivatives and level fields in registers, in the
//     order of csrc/resolve.cu, so that deferred equals forward + gather
//     bit for bit.
//
// The atlas rows come in the four texel formats of
// device/textures.py::texels_tensor, read through Row<format> (by_format
// picks it once per launch): float32 rows are 208 B (a texel is one 16-byte
// load), float16 and bfloat16 rows 104 B (one 8-byte load), srgb8 rows 52 B
// (one 4-byte load; RGB decoded through a 256-entry table that the scene
// upload makes once on the device with the plain version's own
// _srgb_texel, so no powf runs here, alpha by 1/255). Only float32 rows sit
// on the 16-byte grid, so each format loads at its own width.
//
// What bounds it on this card: bytes. Per frame pixel the match plane or
// face id (4 B); per covered pixel 17 G-buffer planes (gather) or its face
// row, one atlas row per probe (~3.1 probes at the orbit frame, 104 B each
// in f16) and 4 output planes; at 1920x1080 about 0.06 ms over 3.35 TB/s
// (chip_smoke.py's bound gives the figure of its run). A probe is ~160
// flops, far below the f32 rate. The design spends nothing on pixels
// without a face or on probes a pixel does not count; a warp runs to its
// worst lane's probe count.

#include "shading.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowTexels = 13;  // 52 channels: the 2x2 quad, then the 3x3 parent window
constexpr int kMaxMips = 16;
// pack_shade_rows: [setup(24) | world(9) | normal(9) | uv(6) | tex-info(49, int32 bits) | pad]
constexpr int kRowWidth = 104;
constexpr int kRowWorld = 24, kRowNormal = 33, kRowUv = 42, kRowTexinfo = 48;
enum Format { kF32 = 0, kF16 = 1, kBF16 = 2, kSrgb8 = 3 };

// The atlas rows in one texel format: texel(r, k, t) reads the four
// channels of texel k (0-12) of row r as f32. The primary template holds
// the 16-bit formats (float16, bfloat16).
template <int kFmt>
struct Row {
  const uint2* __restrict__ base;
  __device__ __forceinline__ static float decode(unsigned bits) {
    return kFmt == kF16 ? f16_bits(bits) : bf16_bits(bits);
  }
  __device__ __forceinline__ void texel(long long r, int k, float t[4]) const {
    const uint2 v = ldg_u2(base + r * kRowTexels + k);
    t[0] = decode(v.x & 0xFFFFu);
    t[1] = decode(v.x >> 16);
    t[2] = decode(v.y & 0xFFFFu);
    t[3] = decode(v.y >> 16);
  }
};

template <>
struct Row<kF32> {
  const float4* __restrict__ base;
  __device__ __forceinline__ void texel(long long r, int k, float t[4]) const {
    const float4 v = ldg_f4(base + r * kRowTexels + k);
    t[0] = v.x;
    t[1] = v.y;
    t[2] = v.z;
    t[3] = v.w;
  }
};

template <>
struct Row<kSrgb8> {
  const unsigned* __restrict__ base;
  const float* __restrict__ lut;  // shade._srgb_texel of 0..255
  __device__ __forceinline__ void texel(long long r, int k, float t[4]) const {
    const unsigned v = ldg_u32(base + r * kRowTexels + k);
    t[0] = lut[v & 0xFFu];
    t[1] = lut[(v >> 8) & 0xFFu];
    t[2] = lut[(v >> 16) & 0xFFu];
    t[3] = (float)(v >> 24) * (float)(1.0 / 255.0);
  }
};

// The fields of a trilinear sample: own mip's atlas offset and size,
// parent mip's size, the mip fraction.
struct Mips {
  int off0, tw0, th0, tw1, th1;
  float tfrac;
};

// torch.remainder of ints by a positive divisor.
__device__ __forceinline__ int int_mod(int a, int b) {
  const int m = a % b;
  return m < 0 ? m + b : m;
}

__device__ __forceinline__ float clamp01(float x) { return min_nan(max_nan(x, 0.0f), 1.0f); }

// shade._trilerp at (u, v): one atlas row, the row index clamped into the
// table, repeat addressing, the parent window's 3x3 weights.
template <class R>
__device__ __forceinline__ void trilerp(const R& rows, long long n_rows, const Mips& m, float u, float v,
                                        float out[4]) {
  const float x = u * (float)m.tw0 - 0.5f;
  const float y = v * (float)m.th0 - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const int x0i = int_mod((int)x0, max(m.tw0, 1));
  const int y0i = int_mod((int)y0, max(m.th0, 1));
  // int32 arithmetic as the plain version's (wrapping, not undefined).
  const int idx32 = (int)((unsigned)m.off0 + (unsigned)y0i * (unsigned)m.tw0 + (unsigned)x0i);
  const long long r = idx32 < 0 ? 0 : ((long long)idx32 > n_rows - 1 ? n_rows - 1 : (long long)idx32);

  const float x1f = u * (float)m.tw1 - 0.5f;
  const float y1f = v * (float)m.th1 - 0.5f;
  const float x1 = floorf(x1f);
  const float y1 = floorf(y1f);
  const float fx1 = x1f - x1;
  const float fy1 = y1f - y1;
  const float dx = clamp01(x1 - floorf((x0 - 1.0f) * 0.5f));
  const float dy = clamp01(y1 - floorf((y0 - 1.0f) * 0.5f));
  const float wx1[3] = {(1.0f - dx) * (1.0f - fx1), (1.0f - dx) * fx1 + dx * (1.0f - fx1), dx * fx1};
  const float wy1[3] = {(1.0f - dy) * (1.0f - fy1), (1.0f - dy) * fy1 + dy * (1.0f - fy1), dy * fy1};
  const float fx_i = 1.0f - fx, fy_i = 1.0f - fy, t_i = 1.0f - m.tfrac;

  float q[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) rows.texel(r, k, q[k]);
  float c1[4];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float t[4];
    rows.texel(r, 4 + k, t);
    const float w = wy1[k / 3] * wx1[k % 3];
#pragma unroll
    for (int c = 0; c < 4; ++c) c1[c] = k == 0 ? w * t[c] : c1[c] + w * t[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float top = q[0][c] * fx_i + q[1][c] * fx;
    const float bot = q[2][c] * fx_i + q[3][c] * fx;
    const float c0 = top * fy_i + bot * fy;
    out[c] = c0 * t_i + c1[c] * m.tfrac;
  }
}

// The albedo of a covered pixel: one trilerp at (u, v) where
// max_anisotropy <= 1, else shade._probe_albedo over the pixel's own
// n_px probes only (a probe the plain version masks adds 0.0 to a sum
// that is never -0, so skipping it changes no bit).
template <class R>
__device__ __forceinline__ void albedo_of(const R& rows, long long n_rows, const Mips& m, float u, float v,
                                          float maj_du, float maj_dv, float span, float n_px, int max_anisotropy,
                                          float albedo[4]) {
  if (max_anisotropy <= 1) {
    trilerp(rows, n_rows, m, u, v, albedo);
    return;
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < max_anisotropy && (float)i < n_px; ++i) {
    const float fo = (((float)i + 0.5f) / n_px - 0.5f) * span;
    float probe[4];
    trilerp(rows, n_rows, m, u + maj_du * fo, v + maj_dv * fo, probe);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] + probe[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) albedo[c] = acc[c] / n_px;
}

template <class R>
__global__ void __launch_bounds__(kThreads)
    shade_gbuffer_kernel(const float* __restrict__ gbuf, R rows, long long n_rows,
                         const float* __restrict__ cam, int height, int width, int max_anisotropy, ShadeParams prm,
                         float* __restrict__ out) {
  const long long plane = (long long)height * width;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  if (!(gbuf[16 * plane + p] > 0.0f)) {
    store_clear(prm, plane, p, out);
    return;
  }
  float g[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = gbuf[i * plane + p];
  const float u = gbuf[6 * plane + p], v = gbuf[7 * plane + p];
  // Offsets ride through f32 as offset/256 (exact), mip dims as small integers.
  const float tw0f = gbuf[9 * plane + p], th0f = gbuf[10 * plane + p];
  const Mips m{(int)gbuf[8 * plane + p] * 256, (int)tw0f, (int)th0f, (int)gbuf[11 * plane + p],
               (int)gbuf[12 * plane + p], gbuf[13 * plane + p]};
  const float maj_du = gbuf[14 * plane + p], maj_dv = gbuf[15 * plane + p], span = gbuf[17 * plane + p];
  const float n_px = probe_count(maj_du, maj_dv, tw0f, th0f, span, max_anisotropy);
  float albedo[4];
  albedo_of(rows, n_rows, m, u, v, maj_du, maj_dv, span, n_px, max_anisotropy, albedo);
  light_store(g, albedo, cam, prm, plane, p, out);
}

// A level field of the face row's texture info (int32 bits): offsets
// (base 0), widths (16) or heights (32) at a level, 0 outside [0, 16)
// (shade._plane_select).
__device__ __forceinline__ int level_field(const int* __restrict__ info, int base, int level) {
  return level >= 0 && level < kMaxMips ? info[base + level] : 0;
}

template <class R>
__global__ void __launch_bounds__(kThreads)
    shade_deferred_kernel(const int* __restrict__ fid, const float* __restrict__ shade_rows, int n_faces,
                          R rows, long long n_rows, const float* __restrict__ cam, int height, int width,
                          int y_offset, int max_anisotropy, ShadeParams prm, float* __restrict__ out) {
  const long long plane = (long long)height * width;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int f = fid[p];
  if (f < 0 || f >= n_faces) {
    store_clear(prm, plane, p, out);
    return;
  }
  const float* s = shade_rows + (long long)f * kRowWidth;
  const int* info = (const int*)(s + kRowTexinfo);
  const float px = ((float)(p % width) + 0.5f) - s[16];
  const float py = ((float)(p / width + y_offset) + 0.5f) - s[17];

  const float e0 = s[0] * px + s[1] * py + s[2];
  const float e1 = s[3] * px + s[4] * py + s[5];
  const float e2 = s[6] * px + s[7] * py + s[8];
  const float esum = e0 + e1 + e2;
  const float eps = 1e-30f;
  const float den = fabsf(esum) < eps ? (esum < 0.0f ? -eps : eps) : esum;
  const float inv = 1.0f / den;
  const float u0 = e0 * inv, u1 = e1 * inv, u2 = e2 * inv;
#define INTERP(b, k) (u0 * s[b] + u1 * s[(b) + (k)] + u2 * s[(b) + 2 * (k)])
  const float g[6] = {INTERP(kRowWorld, 3),      INTERP(kRowWorld + 1, 3),  INTERP(kRowWorld + 2, 3),
                      INTERP(kRowNormal, 3),     INTERP(kRowNormal + 1, 3), INTERP(kRowNormal + 2, 3)};
  const float uv_u = INTERP(kRowUv, 2), uv_v = INTERP(kRowUv + 1, 2);
#undef INTERP

  const float d_x = s[0] + s[3] + s[6];
  const float d_y = s[1] + s[4] + s[7];
  const float inv2 = inv * inv;
  float du_dx, du_dy, dv_dx, dv_dy;
  {
    const float* c = s + kRowUv;
    const float nval = e0 * c[0] + e1 * c[2] + e2 * c[4];
    const float gx = s[0] * c[0] + s[3] * c[2] + s[6] * c[4];
    const float gy = s[1] * c[0] + s[4] * c[2] + s[7] * c[4];
    du_dx = (gx * esum - nval * d_x) * inv2;
    du_dy = (gy * esum - nval * d_y) * inv2;
  }
  {
    const float* c = s + kRowUv + 1;
    const float nval = e0 * c[0] + e1 * c[2] + e2 * c[4];
    const float gx = s[0] * c[0] + s[3] * c[2] + s[6] * c[4];
    const float gy = s[1] * c[0] + s[4] * c[2] + s[7] * c[4];
    dv_dx = (gx * esum - nval * d_x) * inv2;
    dv_dy = (gy * esum - nval * d_y) * inv2;
  }

  const float w0 = (float)info[16], h0 = (float)info[32];
  const int n_mips = info[48];
  const float ax = du_dx * w0, bx = dv_dx * h0;
  const float ay = du_dy * w0, by = dv_dy * h0;
  const float rho2_x = ax * ax + bx * bx;
  const float rho2_y = ay * ay + by * by;
  float rho2, maj_du = 0.0f, maj_dv = 0.0f, span = 0.0f;
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
  }
  float lod = 0.5f * log2f(max_nan(rho2, 1e-24f));
  lod = min_nan(max_nan(lod, 0.0f), (float)(n_mips - 1));
  const float l0f = floorf(lod);
  const int l0 = (int)l0f;
  const int l1 = min(l0 + 1, n_mips - 1);
  const Mips m{level_field(info, 0, l0), level_field(info, 16, l0), level_field(info, 32, l0),
               level_field(info, 16, l1), level_field(info, 32, l1), lod - (float)l0};
  const float n_px = probe_count(maj_du, maj_dv, (float)m.tw0, (float)m.th0, span, max_anisotropy);
  float albedo[4];
  albedo_of(rows, n_rows, m, uv_u, uv_v, maj_du, maj_dv, span, n_px, max_anisotropy, albedo);
  light_store(g, albedo, cam, prm, plane, p, out);
}

// The vector width of a format's texel, the alignment its rows need.
int texel_bytes(int fmt) { return fmt == kF32 ? 16 : fmt == kSrgb8 ? 4 : 8; }

bool rows_ok(const void* texels, long long n_rows, int fmt, const float* lut) {
  return fmt >= kF32 && fmt <= kSrgb8 && n_rows >= 1 && (fmt != kSrgb8 || lut != nullptr) &&
         (uintptr_t)texels % texel_bytes(fmt) == 0;
}

// Calls launch(rows) once, with the atlas rows as their format's Row.
template <class F>
void by_format(int fmt, const void* texels, const float* lut, F&& launch) {
  switch (fmt) {
    case kF32:
      launch(Row<kF32>{(const float4*)texels});
      break;
    case kF16:
      launch(Row<kF16>{(const uint2*)texels});
      break;
    case kBF16:
      launch(Row<kBF16>{(const uint2*)texels});
      break;
    default:
      launch(Row<kSrgb8>{(const unsigned*)texels, lut});
  }
}

int blocks_for(int height, int width) { return (int)(((long long)height * width + kThreads - 1) / kThreads); }

}  // namespace

// texels: (n_rows, 52) rows of format fmt (0 float32, 1 float16, 2
// bfloat16, 3 srgb8 with lut its 256-entry RGB decode table); gbuf: the
// (>= 18, height, width) f32 G-buffer; cam (3,) f32; params: N_PARAMS
// floats of kernels/shade.py::shade_params; out (4, height, width) f32.
extern "C" int tr_shade_gbuffer(const float* gbuf, const void* texels, long long n_rows, int fmt, const float* lut,
                                const float* cam, int height, int width, int max_anisotropy, const float* params,
                                float* out, void* stream) {
  if (!rows_ok(texels, n_rows, fmt, lut)) return (int)cudaErrorInvalidValue;
  const ShadeParams prm = read_shade_params(params);
  const int blocks = blocks_for(height, width);
  if (blocks == 0) return (int)cudaSuccess;
  by_format(fmt, texels, lut, [&](auto rows) {
    TR_LAUNCH(shade_gbuffer_kernel<decltype(rows)>, blocks, kThreads, stream, gbuf, rows, n_rows, cam, height, width,
              max_anisotropy, prm, out);
  });
  return (int)cudaGetLastError();
}

// fid: (height, width) int32 face ids (-1 background); shade_rows:
// (n_faces, 104) f32 from pack_shade_rows; y_offset: the first frame pixel
// row of a slab; the rest as tr_shade_gbuffer.
extern "C" int tr_shade_deferred(const int* fid, const float* shade_rows, int n_faces, const void* texels,
                                 long long n_rows, int fmt, const float* lut, const float* cam, int height, int width,
                                 int y_offset, int max_anisotropy, const float* params, float* out, void* stream) {
  if (!rows_ok(texels, n_rows, fmt, lut)) return (int)cudaErrorInvalidValue;
  const ShadeParams prm = read_shade_params(params);
  const int blocks = blocks_for(height, width);
  if (blocks == 0) return (int)cudaSuccess;
  by_format(fmt, texels, lut, [&](auto rows) {
    TR_LAUNCH(shade_deferred_kernel<decltype(rows)>, blocks, kThreads, stream, fid, shade_rows, n_faces, rows,
              n_rows, cam, height, width, y_offset, max_anisotropy, prm, out);
  });
  return (int)cudaGetLastError();
}

#ifndef TR_HOST_EMU
// Registers per thread and resident blocks per SM of the f16 instances
// (the formats differ only in their loads).
extern "C" int tr_shade_gbuffer_info(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, shade_gbuffer_kernel<Row<kF16>>);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, shade_gbuffer_kernel<Row<kF16>>, kThreads, 0);
}

extern "C" int tr_shade_deferred_info(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, shade_deferred_kernel<Row<kF16>>);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, shade_deferred_kernel<Row<kF16>>, kThreads,
                                                            0);
}
#endif
