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
// One thread shades one pixel, in pixel order (consecutive threads on
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
//   * the deferred kernel reads the fields of the pixel's face row (104
//     floats of pack_shade_rows) and repeats shade_deferred's edge
//     functions, interpolation, UV derivatives and level fields in
//     registers, in the order of csrc/resolve.cu, so that deferred equals
//     forward + gather bit for bit.
//
// What bounds it on this card: L1 requests, not bytes. The 32 lanes of a
// warp are 32 pixels whose rows lie apart, so a warp-wide load touches up
// to 32 lines of 128 B, and L1 serves it as one request per line, however
// few bytes each lane takes. Loading each texel on its own (13 loads a
// probe) gave 15.3M requests at the orbit frame (1920x1080, anisotropy 16,
// float16 rows), 0.059 ms at 1.98 GHz over 132 SMs against 0.074 ms
// measured, and the same time in every texel width (chip_smoke.py's
// shade_warp_lines; PERF.md section 6). So each lane reads its row
// in as few loads as the row's alignment allows, each on its own lane's
// line: a float16 / bfloat16 row (104 B, on the 16-byte grid at every
// other row) is six 16-byte loads and one 8-byte load, their order by the
// row's parity; an srgb8 row (52 B) six 8-byte loads and one 4-byte load;
// a float32 row (208 B) thirteen 16-byte loads. That is 7 requests a probe
// where there were 13, and all of a probe's loads are in flight together.
// The deferred kernel reads its face row's fields the same way: ten
// 16-byte loads for fields 0-11, 16-19 and 24-47, three for the texture
// info at level 0 (widths, heights, mip count), and the five level fields
// it picks, 18 loads where there were 43.
//
// These loads brought the orbit frame to 8.1M requests and the kernels'
// device time from 0.074 / 0.075 ms to 0.064 / 0.067 ms; what holds them now
// is not the requests (0.031 ms of it) but each warp's chain of dependent
// reads (match plane, G-buffer or face row, each probe's row).
//
// Measured and deleted (PERF.md section 6): staging each round's
// rows in shared memory, copied by the whole warp with cp.async (about 3
// lines a warp-wide copy), with a warp's probes spread over its lanes or
// one probe index a round, and the deferred kernel's face rows staged the
// same way: the rounds' waits and barriers cost more than the requests
// saved; two probes' rows loaded before either is blended (75-80
// registers, 3 blocks a SM); an L1 prefetch of the next probe's row (two
// more requests a probe).
//
// srgb8 rows decode RGB through a 256-entry table that the scene upload
// makes once on the device with the plain version's own _srgb_texel (so no
// powf runs here), copied into shared memory once per block; alpha is
// byte / 255.

#include "shading.cuh"

namespace {

// 256 threads a block, at least 4 blocks a SM (64 registers a thread): the
// faster of the limits measured (PERF.md section 6; without the bound
// the deferred kernel on bfloat16 rows took 74 registers and 3 blocks).
constexpr int kThreads = 256, kMinBlocks = 4;
constexpr int kRowTexels = 13;  // 52 channels: the 2x2 quad, then the 3x3 parent window
constexpr int kMaxMips = 16;
// pack_shade_rows: [setup(24) | world(9) | normal(9) | uv(6) | tex-info(49, int32 bits) | pad]
constexpr int kRowWidth = 104;
constexpr int kRowWorld = 24, kRowNormal = 33, kRowUv = 42, kRowTexinfo = 48;
enum Format { kF32 = 0, kF16 = 1, kBF16 = 2, kSrgb8 = 3 };

// Texel k of a row read as six two-texel blocks w and one texel s: a row on
// the blocks' grid (even) is w[0..5] then s, an odd row s then w[0..5];
// lo / hi pick a block's first or second texel.
template <int k, class T, class B, class Lo, class Hi>
__device__ __forceinline__ T pick(bool odd, const B w[6], T s, Lo lo, Hi hi) {
  const T even_t = k == 12 ? s : (k % 2 == 0 ? lo(w[k < 12 ? k / 2 : 0]) : hi(w[k < 12 ? k / 2 : 0]));
  const int j = k == 0 ? 0 : (k - 1) / 2;
  const T odd_t = k == 0 ? s : ((k - 1) % 2 == 0 ? lo(w[j]) : hi(w[j]));
  return odd ? odd_t : even_t;
}

// The 13 texels of a row read as pick() takes them.
template <class T, class B, class Lo, class Hi>
__device__ __forceinline__ void pick_row(bool odd, const B w[6], T s, Lo lo, Hi hi, T t[13]) {
  t[0] = pick<0>(odd, w, s, lo, hi);
  t[1] = pick<1>(odd, w, s, lo, hi);
  t[2] = pick<2>(odd, w, s, lo, hi);
  t[3] = pick<3>(odd, w, s, lo, hi);
  t[4] = pick<4>(odd, w, s, lo, hi);
  t[5] = pick<5>(odd, w, s, lo, hi);
  t[6] = pick<6>(odd, w, s, lo, hi);
  t[7] = pick<7>(odd, w, s, lo, hi);
  t[8] = pick<8>(odd, w, s, lo, hi);
  t[9] = pick<9>(odd, w, s, lo, hi);
  t[10] = pick<10>(odd, w, s, lo, hi);
  t[11] = pick<11>(odd, w, s, lo, hi);
  t[12] = pick<12>(odd, w, s, lo, hi);
}

// The atlas rows in one texel format: load(r, t) reads the 13 texels of
// row r into registers (Chunk: one texel as stored), decode(t, lut, c)
// gives a texel's four channels as f32. The primary template holds the
// 16-bit formats (float16, bfloat16): 104-byte rows, the base on the
// 16-byte grid.
template <int kFmt>
struct Row {
  using Chunk = uint2;
  static constexpr int kLut = 0;
  const unsigned char* __restrict__ base;
  __device__ __forceinline__ void load(long long r, Chunk t[kRowTexels]) const {
    const unsigned char* row = base + r * (kRowTexels * 8);
    const bool odd = (r & 1) != 0;
    const float4* wide = (const float4*)(row + (odd ? 8 : 0));
    float4 w[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) w[j] = ldg_f4(wide + j);
    const uint2 s = ldg_u2((const uint2*)(row + (odd ? 0 : 96)));
    pick_row(
        odd, w, s, [](const float4& b) { return uint2{__float_as_uint(b.x), __float_as_uint(b.y)}; },
        [](const float4& b) { return uint2{__float_as_uint(b.z), __float_as_uint(b.w)}; }, t);
  }
  __device__ __forceinline__ static float channel(unsigned bits) {
    return kFmt == kF16 ? f16_bits(bits) : bf16_bits(bits);
  }
  __device__ __forceinline__ static void decode(const Chunk& v, const float*, float c[4]) {
    c[0] = channel(v.x & 0xFFFFu);
    c[1] = channel(v.x >> 16);
    c[2] = channel(v.y & 0xFFFFu);
    c[3] = channel(v.y >> 16);
  }
};

// float32 rows: 208 bytes, every texel a 16-byte load.
template <>
struct Row<kF32> {
  using Chunk = float4;
  static constexpr int kLut = 0;
  const float4* __restrict__ base;
  __device__ __forceinline__ void load(long long r, Chunk t[kRowTexels]) const {
#pragma unroll
    for (int k = 0; k < kRowTexels; ++k) t[k] = ldg_f4(base + r * kRowTexels + k);
  }
  __device__ __forceinline__ static void decode(const Chunk& v, const float*, float c[4]) {
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
  }
};

// srgb8 rows: 52 bytes, the base on the 8-byte grid; decode's lut is the
// block's shared copy of the table.
template <>
struct Row<kSrgb8> {
  using Chunk = unsigned;
  static constexpr int kLut = 256;
  const unsigned char* __restrict__ base;
  const float* __restrict__ lut;  // shade._srgb_texel of 0..255, in device memory
  __device__ __forceinline__ void load(long long r, Chunk t[kRowTexels]) const {
    const unsigned char* row = base + r * (kRowTexels * 4);
    const bool odd = (r & 1) != 0;
    const uint2* wide = (const uint2*)(row + (odd ? 4 : 0));
    uint2 w[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) w[j] = ldg_u2(wide + j);
    const unsigned s = ldg_u32((const unsigned*)(row + (odd ? 0 : 48)));
    pick_row(
        odd, w, s, [](const uint2& b) { return b.x; }, [](const uint2& b) { return b.y; }, t);
  }
  __device__ __forceinline__ static void decode(const Chunk& v, const float* lut, float c[4]) {
    c[0] = lut[v & 0xFFu];
    c[1] = lut[(v >> 8) & 0xFFu];
    c[2] = lut[(v >> 16) & 0xFFu];
    c[3] = (float)(v >> 24) * (float)(1.0 / 255.0);
  }
};

// The block's shared copy of the srgb8 decode table (load: a block barrier,
// so every thread of the block calls it); the other formats have none.
template <class R>
struct Lut {
  float table[R::kLut > 0 ? R::kLut : 1];
  __device__ __forceinline__ const float* load(const R& rows) {
    if constexpr (R::kLut > 0) {
      for (int i = threadIdx.x; i < R::kLut; i += kThreads) table[i] = rows.lut[i];
      __syncthreads();
    }
    return table;
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
__device__ __forceinline__ void trilerp(const R& rows, const float* lut, long long n_rows, const Mips& m, float u,
                                        float v, float out[4]) {
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
  typename R::Chunk t[kRowTexels];
  rows.load(r, t);

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
  for (int k = 0; k < 4; ++k) R::decode(t[k], lut, q[k]);
  float c1[4];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float c[4];
    R::decode(t[4 + k], lut, c);
    const float w = wy1[k / 3] * wx1[k % 3];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) c1[ch] = k == 0 ? w * c[ch] : c1[ch] + w * c[ch];
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
__device__ __forceinline__ void albedo_of(const R& rows, const float* lut, long long n_rows, const Mips& m, float u,
                                          float v, float maj_du, float maj_dv, float span, float n_px,
                                          int max_anisotropy, float albedo[4]) {
  if (max_anisotropy <= 1) {
    trilerp(rows, lut, n_rows, m, u, v, albedo);
    return;
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < max_anisotropy && (float)i < n_px; ++i) {
    const float fo = (((float)i + 0.5f) / n_px - 0.5f) * span;
    float probe[4];
    trilerp(rows, lut, n_rows, m, u + maj_du * fo, v + maj_dv * fo, probe);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = acc[c] + probe[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) albedo[c] = acc[c] / n_px;
}

template <class R>
__device__ __forceinline__ void shade_gbuffer_pixel(const float* __restrict__ gbuf, const R& rows, long long n_rows,
                                                    const float* __restrict__ cam, int height, int width,
                                                    int max_anisotropy, const ShadeParams& prm,
                                                    float* __restrict__ out) {
  __shared__ Lut<R> shared_lut;
  const float* lut = shared_lut.load(rows);
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
  albedo_of(rows, lut, n_rows, m, u, v, maj_du, maj_dv, span, n_px, max_anisotropy, albedo);
  light_store(g, albedo, cam, prm, plane, p, out);
}

template <class R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    shade_gbuffer_kernel(const float* __restrict__ gbuf, R rows, long long n_rows,
                         const float* __restrict__ cam, int height, int width, int max_anisotropy, ShadeParams prm,
                         float* __restrict__ out, long long* mark_start, long long* mark_end) {
  stamp_start(mark_start);
  shade_gbuffer_pixel(gbuf, rows, n_rows, cam, height, width, max_anisotropy, prm, out);
  stamp_end(mark_end);
}

// A level field of the face row's texture info (int32 bits): offsets
// (base 0), widths (16) or heights (32) at a level, 0 outside [0, 16)
// (shade._plane_select).
__device__ __forceinline__ int level_field(const int* __restrict__ info, int base, int level) {
  return level >= 0 && level < kMaxMips ? info[base + level] : 0;
}

// Fields 4b-4b+3 of a face row (16-byte block b) into s.
template <int b>
__device__ __forceinline__ void face_block(const float4* __restrict__ row4, float s[48]) {
  const float4 v = ldg_f4(row4 + b);
  s[4 * b] = v.x;
  s[4 * b + 1] = v.y;
  s[4 * b + 2] = v.z;
  s[4 * b + 3] = v.w;
}

template <class R>
__device__ __forceinline__ void shade_deferred_pixel(const int* __restrict__ fid, const float* __restrict__ shade_rows,
                                                     int n_faces, const R& rows, long long n_rows,
                                                     const float* __restrict__ cam, int height, int width,
                                                     int y_offset, int max_anisotropy, const ShadeParams& prm,
                                                     float* __restrict__ out) {
  __shared__ Lut<R> shared_lut;
  const float* lut = shared_lut.load(rows);
  const long long plane = (long long)height * width;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int f = fid[p];
  if (f < 0 || f >= n_faces) {
    store_clear(prm, plane, p, out);
    return;
  }
  const float4* row4 = (const float4*)(shade_rows + (long long)f * kRowWidth);
  // The 16-byte blocks it reads whole: fields 0-11 (the edge functions,
  // 0-8), 16-19 (the anchor, 16 and 17) and 24-47 (world, normal, uv).
  float s[48];
  face_block<0>(row4, s);
  face_block<1>(row4, s);
  face_block<2>(row4, s);
  face_block<4>(row4, s);
  face_block<6>(row4, s);
  face_block<7>(row4, s);
  face_block<8>(row4, s);
  face_block<9>(row4, s);
  face_block<10>(row4, s);
  face_block<11>(row4, s);
  // The texture info: widths, heights and mip count at level 0 as the
  // first fields of three 16-byte blocks; the level fields one by one.
  const int* info = (const int*)(shade_rows + (long long)f * kRowWidth + kRowTexinfo);
  const float w0 = (float)(int)__float_as_uint(ldg_f4(row4 + (kRowTexinfo + 16) / 4).x);
  const float h0 = (float)(int)__float_as_uint(ldg_f4(row4 + (kRowTexinfo + 32) / 4).x);
  const int n_mips = (int)__float_as_uint(ldg_f4(row4 + (kRowTexinfo + 48) / 4).x);
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
  albedo_of(rows, lut, n_rows, m, uv_u, uv_v, maj_du, maj_dv, span, n_px, max_anisotropy, albedo);
  light_store(g, albedo, cam, prm, plane, p, out);
}

template <class R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    shade_deferred_kernel(const int* __restrict__ fid, const float* __restrict__ shade_rows, int n_faces,
                          R rows, long long n_rows, const float* __restrict__ cam, int height, int width,
                          int y_offset, int max_anisotropy, ShadeParams prm, float* __restrict__ out,
                          long long* mark_start, long long* mark_end) {
  stamp_start(mark_start);
  shade_deferred_pixel(fid, shade_rows, n_faces, rows, n_rows, cam, height, width, y_offset, max_anisotropy, prm,
                       out);
  stamp_end(mark_end);
}

// The alignment a format's rows need: float32 and the 16-bit formats 16
// bytes, srgb8 8.
int row_alignment(int fmt) { return fmt == kSrgb8 ? 8 : 16; }

bool rows_ok(const void* texels, long long n_rows, int fmt, const float* lut) {
  return fmt >= kF32 && fmt <= kSrgb8 && n_rows >= 1 && (fmt != kSrgb8 || lut != nullptr) &&
         (uintptr_t)texels % row_alignment(fmt) == 0;
}

// Calls launch(rows) once, with the atlas rows as their format's Row.
template <class F>
void by_format(int fmt, const void* texels, const float* lut, F&& launch) {
  switch (fmt) {
    case kF32:
      launch(Row<kF32>{(const float4*)texels});
      break;
    case kF16:
      launch(Row<kF16>{(const unsigned char*)texels});
      break;
    case kBF16:
      launch(Row<kBF16>{(const unsigned char*)texels});
      break;
    default:
      launch(Row<kSrgb8>{(const unsigned char*)texels, lut});
  }
}

int blocks_for(int height, int width) { return (int)(((long long)height * width + kThreads - 1) / kThreads); }

}  // namespace

// texels: (n_rows, 52) rows of format fmt (0 float32, 1 float16, 2
// bfloat16, 3 srgb8 with lut its 256-entry RGB decode table), starting on
// the 16-byte grid (srgb8: the 8-byte grid); gbuf: the (>= 18, height,
// width) f32 G-buffer; cam (3,) f32; params: N_PARAMS floats of
// kernels/shade.py::shade_params; out (4, height, width) f32; mark_start,
// mark_end: the frame trace's words for the kernel's start and end, or
// nullptr (common.cuh).
extern "C" int tr_shade_gbuffer(const float* gbuf, const void* texels, long long n_rows, int fmt, const float* lut,
                                const float* cam, int height, int width, int max_anisotropy, const float* params,
                                float* out, long long* mark_start, long long* mark_end, void* stream) {
  if (!rows_ok(texels, n_rows, fmt, lut)) return (int)cudaErrorInvalidValue;
  const ShadeParams prm = read_shade_params(params);
  const int blocks = blocks_for(height, width);
  if (blocks == 0) return (int)cudaSuccess;
  by_format(fmt, texels, lut, [&](auto rows) {
    TR_LAUNCH(shade_gbuffer_kernel<decltype(rows)>, blocks, kThreads, stream, gbuf, rows, n_rows, cam, height, width,
              max_anisotropy, prm, out, mark_start, mark_end);
  });
  return (int)cudaGetLastError();
}

// fid: (height, width) int32 face ids (-1 background); shade_rows:
// (n_faces, 104) f32 from pack_shade_rows, on the 16-byte grid; y_offset:
// the first frame pixel row of a slab; the rest as tr_shade_gbuffer.
extern "C" int tr_shade_deferred(const int* fid, const float* shade_rows, int n_faces, const void* texels,
                                 long long n_rows, int fmt, const float* lut, const float* cam, int height, int width,
                                 int y_offset, int max_anisotropy, const float* params, float* out,
                                 long long* mark_start, long long* mark_end, void* stream) {
  if (!rows_ok(texels, n_rows, fmt, lut) || (uintptr_t)shade_rows % 16 != 0) return (int)cudaErrorInvalidValue;
  const ShadeParams prm = read_shade_params(params);
  const int blocks = blocks_for(height, width);
  if (blocks == 0) return (int)cudaSuccess;
  by_format(fmt, texels, lut, [&](auto rows) {
    TR_LAUNCH(shade_deferred_kernel<decltype(rows)>, blocks, kThreads, stream, fid, shade_rows, n_faces, rows,
              n_rows, cam, height, width, y_offset, max_anisotropy, prm, out, mark_start, mark_end);
  });
  return (int)cudaGetLastError();
}

#ifndef TR_HOST_EMU
namespace {

// Registers per thread, resident blocks per SM, threads and static shared
// bytes per block of one kernel instance.
template <class K>
int kernel_attrs(K kernel, int* registers, int* blocks_per_sm, int* threads, int* shared_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  *threads = kThreads;
  *shared_bytes = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, 0);
}

}  // namespace

// The instance of the rows' format fmt (as tr_shade_gbuffer's).
extern "C" int tr_shade_gbuffer_info(int fmt, int* registers, int* blocks_per_sm, int* threads, int* shared_bytes) {
  if (fmt < kF32 || fmt > kSrgb8) return (int)cudaErrorInvalidValue;
  int err = 0;
  by_format(fmt, nullptr, nullptr, [&](auto rows) {
    err = kernel_attrs(shade_gbuffer_kernel<decltype(rows)>, registers, blocks_per_sm, threads, shared_bytes);
  });
  return err;
}

extern "C" int tr_shade_deferred_info(int fmt, int* registers, int* blocks_per_sm, int* threads, int* shared_bytes) {
  if (fmt < kF32 || fmt > kSrgb8) return (int)cudaErrorInvalidValue;
  int err = 0;
  by_format(fmt, nullptr, nullptr, [&](auto rows) {
    err = kernel_attrs(shade_deferred_kernel<decltype(rows)>, registers, blocks_per_sm, threads, shared_bytes);
  });
  return err;
}
#endif
