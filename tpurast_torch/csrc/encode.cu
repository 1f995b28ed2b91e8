// The sRGB u8 encode: each pixel of a frame's (height, width) crop, from the
// (4, Hp, Wp) linear f32 framebuffer to four u8 planes, in one pass
// (tpurast_torch/kernels/present.py encode_srgb_u8_plain; encode_srgb_u8
// launches this for CUDA tensors). Replaces the reference's
// present.encode_srgb_u8 (tpurast/kernels/present.py), which is XLA ops: no
// pallas_call stands behind it. The port's plain version is about a dozen
// torch ops (clamp, compare, two products, pow, difference, select, the alpha
// clamp, cat, product, round, cast), each a pass over the frame.
//
// What bounds it: a stream. Each pixel of the crop reads its four f32 planes
// (16 B) and writes its four bytes: 165.9 MB at 3840x2160, 0.0495 ms at
// 3.35 TB/s. So the design moves those bytes once, in wide coalesced
// accesses:
//
//   * a thread takes four adjacent pixels of a row (a quad), consecutive
//     threads consecutive quads of a row, a thread for every quad of the crop;
//   * a streaming 16-byte load per plane (ld_stream_f4: the frame is read
//     once) where the rows start on the 16-byte grid (Wp a multiple of 4 and
//     the planes on the grid: always so on the frame path, whose rows are
//     whole 128-pixel tiles), else a 4-byte load per pixel of the crop;
//   * one 4-byte store per output plane (st_u32) where the crop's width is a
//     multiple of 4 and the output starts on the 4-byte grid, else a byte a
//     pixel.
//
// The arithmetic is the plain version's, one rounding per operation (built
// with --fmad=false): a colour channel c = clamp(x, 0, 1), then
// c <= 0.0031308f ? c * 12.92f : 1.055f * powf(c, (float)(1.0 / 2.4)) - 0.055f
// (torch compares and multiplies a float32 tensor with a Python number in
// float32, and pow takes the exponent as float32); alpha clamp(x, 0, 1); then
// rintf(v * 255.0f) (torch.round: ties to even), cast to u8. The clamps pass
// NaN on, as torch.clamp does, and a NaN becomes 0, as torch's cast through
// int64 makes it on the card.
//
// powf is the one costly term: with powf on every channel a 4K frame of
// random values took 0.101 ms, twice the bound (PERF.md section 6). So the
// curve is taken first from the card's fast power (fast_powf: two
// special-function instructions). Over every c in (0.0031308, 1] that value
// lies within 6.1e-5 of the exact one, in units of the byte, so wherever it
// is at least kTieMargin (16 times that) from a rounding boundary k + 0.5,
// both round to the same byte. Only a value within the margin, 0.2% of them,
// takes powf and the plain version's terms. chip_smoke.py --encode-kernel
// holds the kernel to the plain version on the card for every float32 in
// [0, 1].
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLinearMax = 0.0031308f;  // present.py linear_to_srgb's threshold, as float32
constexpr float kInvGamma = (float)(1.0 / 2.4);
constexpr float kTieMargin = 1.0f / 1024;  // in units of the byte

__device__ __forceinline__ float clamp01(float x) { return min_nan(max_nan(x, 0.0f), 1.0f); }

// torch.round(v).to(torch.uint8) of v in [0, 255] or NaN.
__device__ __forceinline__ unsigned to_u8(float v) {
  const float r = rintf(v);
  return r == r ? (unsigned)(int)r : 0u;
}

// 255 (1.055 c^(1/2.4) - 0.055) for c past the threshold (or NaN), rounded to
// the byte as the plain version rounds it.
__device__ __forceinline__ unsigned curve_u8(float c) {
  const float fast = (1.055f * fast_powf(c, kInvGamma) - 0.055f) * 255.0f;
  if (fabsf(fast - floorf(fast) - 0.5f) >= kTieMargin) return to_u8(fast);
  return to_u8((1.055f * powf(c, kInvGamma) - 0.055f) * 255.0f);
}

__device__ __forceinline__ unsigned encode_channel(int plane, float x) {
  const float c = clamp01(x);
  if (plane == 3 || c <= kLinearMax) return to_u8((plane == 3 ? c : c * 12.92f) * 255.0f);
  return curve_u8(c);
}

__global__ void __launch_bounds__(kThreads) encode_kernel(const float* __restrict__ planes, long long plane_in,
                                                          int wp, int width, int height, bool wide_in,
                                                          bool wide_out, unsigned char* out) {
  const int quads_x = (width + 3) / 4;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= (long long)quads_x * height) return;
  const long long y = q / quads_x, plane_out = (long long)width * height;
  const int x = 4 * (int)(q - y * quads_x);
  const int n = min(4, width - x);  // pixels of the quad inside the crop
  const float* src = planes + y * wp + x;
  unsigned char* dst = out + y * width + x;
  for (int p = 0; p < 4; ++p) {
    float v[4];
    if (wide_in) {
      const float4 f = ld_stream_f4(reinterpret_cast<const float4*>(src + p * plane_in));
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
      for (int i = 0; i < 4; ++i) v[i] = i < n ? src[p * plane_in + i] : 0.0f;
    }
    unsigned b[4];
    for (int i = 0; i < 4; ++i) b[i] = encode_channel(p, v[i]);
    if (wide_out) {
      st_u32(reinterpret_cast<unsigned*>(dst + p * plane_out), b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24);
    } else {
      for (int i = 0; i < n; ++i) dst[p * plane_out + i] = (unsigned char)b[i];
    }
  }
}

}  // namespace

// The sRGB u8 encode of the (height, width) crop of planes, a contiguous
// (4, hp, wp) f32 framebuffer, into out, a contiguous (4, height, width) u8
// tensor. The wide loads and stores are taken where the pointers and sizes
// allow them (see above), so any alignment is served.
extern "C" int tr_encode(const float* planes, int hp, int wp, int width, int height, unsigned char* out,
                         void* stream) {
  if (width < 0 || height < 0 || width > wp || height > hp) return (int)cudaErrorInvalidValue;
  if (width == 0 || height == 0) return (int)cudaSuccess;
  const long long quads = (long long)(width + 3) / 4 * height;
  const bool wide_in = wp % 4 == 0 && (uintptr_t)planes % 16 == 0;
  const bool wide_out = width % 4 == 0 && (uintptr_t)out % 4 == 0;
  TR_LAUNCH(encode_kernel, (int)((quads + kThreads - 1) / kThreads), kThreads, stream, planes, (long long)hp * wp, wp,
            width, height, wide_in, wide_out, out);
  return (int)cudaGetLastError();
}

#ifndef TR_HOST_EMU
extern "C" int tr_encode_info(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, encode_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, encode_kernel, kThreads, 0);
}
#endif
