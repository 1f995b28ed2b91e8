// Triangle setup: each face's clip-space corners, its rasterization row, its
// screen box, its valid flag and its determinant, in one pass
// (tpurast_torch/kernels/geometry.py transform_corners, then triangle_setup
// on the corners; setup_faces launches this for CUDA tensors). Replaces the
// reference's transform_corners and triangle_setup
// (tpurast/kernels/geometry.py), which are XLA ops: no pallas_call stands
// behind them. The port's plain version is some 136 torch ops, each a trip
// through device memory for its intermediates.
//
// What bounds it: a stream. Each face reads its 36 B of world corners and
// writes 48 B of clip corners, the 96 B setup row, the 16 B box, the 4 B
// determinant and the 1 B flag: 201 B, 0.074 ms for 1.24M faces at
// 3.35 TB/s. The arithmetic (a 4x4 transform of three corners, three
// divisions, nine cross-product components in float64) is far under the
// card's rates. So the design moves those bytes once, in wide coalesced
// accesses, and keeps every intermediate in registers:
//
//   * a thread a face, kThreads faces a block;
//   * the block's corners (kThreads * 9 floats, a whole number of 16-byte
//     words) read into shared memory with 16-byte loads, the face count's
//     remainder of a last block with 4-byte loads; each thread then reads
//     its nine floats there (a stride of 9 words: no bank conflict);
//   * the clip corners (three 16-byte words a face) and the setup rows (six)
//     staged in shared memory, the clip rows where the corners were, and
//     written out by consecutive threads to consecutive 16-byte words; the
//     box a 16-byte store a thread, the determinant and the flag one store.
//
// The arithmetic is the plain version's, one rounding per operation (built
// with --fmad=false, IEEE division): the transform's sum in its order,
// (x*m0 + y*m1) + (z*m2 + m3); the cross products as the plain _cross
// computes them, the first product in float64 (exact), the second rounded in
// float32, their difference in float64, then rounded to float32 (no fmaf:
// one rounding can differ from these two); rintf for torch.round (ties to
// even); the anchor's clamp and the box's minima and maxima passing NaN on
// as torch.clamp, amin and amax do (fminf and fmaxf drop it), the first of
// equal values kept as amin and amax keep it on the CPU. So every output is
// the same bits as the plain version's, NaN positions included.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;                  // faces a block
constexpr int kRowWidth = 24;                  // geometry.py SETUP_WIDTH
constexpr int kCornerWords = kThreads * 9 / 4; // 16-byte words of a block's world corners
constexpr int kClipWords = kThreads * 3;       // of its clip corners
constexpr int kRowWords = kThreads * kRowWidth / 4;
constexpr float kEyeEps = 1e-20f;              // geometry.py EYE_EPS (triangle_setup's eps)

static_assert(kCornerWords <= kClipWords, "the clip rows are staged where the corners were");

__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) <= 3.40282346638528859812e+38f; }

// torch.amin / amax of two, NaN passed on, the first of two equal values
// (-0.0 and 0.0) kept.
__device__ __forceinline__ float min_first(float a, float b) { return a != a ? a : b != b ? b : b < a ? b : a; }
__device__ __forceinline__ float max_first(float a, float b) { return a != a ? a : b != b ? b : b > a ? b : a; }

// One component of cross(a, b): a_i * b_j - a_j * b_i (geometry.py _cross).
__device__ __forceinline__ float cross_comp(const float* a, const float* b, int i, int j) {
  return (float)((double)a[i] * (double)b[j] - (double)(a[j] * b[i]));
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = cross_comp(a, b, 1, 2);
  out[1] = cross_comp(a, b, 2, 0);
  out[2] = cross_comp(a, b, 0, 1);
}

__global__ void __launch_bounds__(kThreads) setup_kernel(const float* __restrict__ corner_world,
                                                         const float* __restrict__ view_proj, int rows, int n_faces,
                                                         int width, int height, float4* clip, float4* setup,
                                                         unsigned char* valid, float4* aabb, float* det) {
  __shared__ float4 stage[kClipWords + kRowWords];  // corners, then clip rows; setup rows
  float* const words = reinterpret_cast<float*>(stage);
  const long long base = (long long)blockIdx.x * kThreads;
  const int n = (int)min((long long)kThreads, rows - base);  // faces of this block
  const int t = threadIdx.x;

  const float* src = corner_world + base * 9;
  const int floats = n * 9, wide = floats / 4;
  for (int i = t; i < wide; i += kThreads) stage[i] = ldg_f4(reinterpret_cast<const float4*>(src) + i);
  if (t < floats - 4 * wide) words[4 * wide + t] = src[4 * wide + t];
  float m[16];
  for (int k = 0; k < 16; ++k) m[k] = view_proj[k];
  __syncthreads();
  float p[9];
  for (int k = 0; k < 9; ++k) p[k] = t < n ? words[9 * t + k] : 0.0f;
  __syncthreads();  // every corner read before the clip rows take their place

  if (t < n) {
    const long long f = base + t;
    // transform_corners: clip = world_h @ view_proj.T.
    float c[3][4];
    for (int i = 0; i < 3; ++i) {
      const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
      for (int k = 0; k < 4; ++k) c[i][k] = (x * m[4 * k] + y * m[4 * k + 1]) + (z * m[4 * k + 2] + m[4 * k + 3]);
      stage[3 * t + i] = make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
    }

    // triangle_setup.
    const float half_w = (float)(width * 0.5), half_h = (float)(height * 0.5);
    const float fw = (float)width, fh = (float)height;
    float sx[3], sy[3], v[3][3];
    bool ok[3];
    bool finite = true;
    for (int i = 0; i < 3; ++i) {
      const float w = c[i][3];
      const float vx = (c[i][0] + w) * half_w, vy = (w - c[i][1]) * half_h;
      ok[i] = w > kEyeEps;
      sx[i] = ok[i] ? vx / w : 0.0f;
      sy[i] = ok[i] ? vy / w : 0.0f;
      v[i][0] = vx;
      v[i][1] = vy;
      v[i][2] = w;
      for (int k = 0; k < 4; ++k) finite = finite && is_finite(c[i][k]);
    }
    const bool any_ok = ok[0] || ok[1] || ok[2], all_ok = ok[0] && ok[1] && ok[2];
    // The anchor: the first corner in front of the eye, its screen point
    // rounded and clamped (corner 0's, 0, where none is).
    const float fx = ok[0] ? sx[0] : ok[1] ? sx[1] : ok[2] ? sx[2] : sx[0];
    const float fy = ok[0] ? sy[0] : ok[1] ? sy[1] : ok[2] ? sy[2] : sy[0];
    const float ax = any_ok ? min_nan(max_nan(rintf(fx), (float)(-4 * width)), (float)(5 * width)) : 0.0f;
    const float ay = any_ok ? min_nan(max_nan(rintf(fy), (float)(-4 * height)), (float)(5 * height)) : 0.0f;
    for (int i = 0; i < 3; ++i) {
      v[i][0] = v[i][0] - ax * v[i][2];
      v[i][1] = v[i][1] - ay * v[i][2];
    }
    float e[3][3];
    cross3(v[1], v[2], e[0]);
    cross3(v[2], v[0], e[1]);
    cross3(v[0], v[1], e[2]);
    const float d = (e[0][0] * v[0][0] + e[0][1] * v[0][1]) + e[0][2] * v[0][2];

    // The screen box: the whole screen where a corner is behind the eye
    // (so the plain version's +-1e9 stand-ins for such corners never reach
    // it), else the corners' bounds.
    const float minx = all_ok ? min_first(min_first(sx[0], sx[1]), sx[2]) : 0.0f;
    const float miny = all_ok ? min_first(min_first(sy[0], sy[1]), sy[2]) : 0.0f;
    const float maxx = all_ok ? max_first(max_first(sx[0], sx[1]), sx[2]) : fw;
    const float maxy = all_ok ? max_first(max_first(sy[0], sy[1]), sy[2]) : fh;
    const bool on_screen = maxx >= 0.0f && maxy >= 0.0f && minx < fw && miny < fh;
    valid[f] = (unsigned char)(f < n_faces && finite && d < 0.0f && any_ok && on_screen);
    st_f4(aabb + f, make_float4(minx, miny, maxx, maxy));
    det[f] = d;

    // [E(9), z_clip(3), w_clip(3), face_id, anchor_x, anchor_y, ymin, ymax, pad(4)].
    float4* row = stage + kClipWords + kRowWidth / 4 * t;
    row[0] = make_float4(e[0][0], e[0][1], e[0][2], e[1][0]);
    row[1] = make_float4(e[1][1], e[1][2], e[2][0], e[2][1]);
    row[2] = make_float4(e[2][2], c[0][2], c[1][2], c[2][2]);
    row[3] = make_float4(c[0][3], c[1][3], c[2][3], (float)f);
    row[4] = make_float4(ax, ay, miny, maxy);
    row[5] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  for (int i = t; i < 3 * n; i += kThreads) st_f4(clip + 3 * base + i, stage[i]);
  for (int i = t; i < kRowWidth / 4 * n; i += kThreads) st_f4(setup + kRowWidth / 4 * base + i, stage[kClipWords + i]);
}

}  // namespace

// The setup of `rows` faces (corner_world (rows, 3, 3) f32, on the 16-byte
// grid) under view_proj ((4, 4) f32, read on the device, so that a CUDA
// graph's replay reads the frame's matrix) for a width x height frame; faces
// from n_faces on are padding (never valid). Writes clip (rows, 3, 4),
// setup (rows, 24), valid (rows,) bool, aabb (rows, 4) and det (rows,), the
// 16-byte outputs on the 16-byte grid.
extern "C" int tr_setup(const float* corner_world, const float* view_proj, int rows, int n_faces, int width,
                        int height, float* clip, float* setup, unsigned char* valid, float* aabb, float* det,
                        void* stream) {
  const uintptr_t grid16 = (uintptr_t)corner_world | (uintptr_t)clip | (uintptr_t)setup | (uintptr_t)aabb;
  if (rows < 0 || grid16 % 16 != 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  TR_LAUNCH(setup_kernel, (rows + kThreads - 1) / kThreads, kThreads, stream, corner_world, view_proj, rows, n_faces,
            width, height, reinterpret_cast<float4*>(clip), reinterpret_cast<float4*>(setup), valid,
            reinterpret_cast<float4*>(aabb), det);
  return (int)cudaGetLastError();
}

#ifndef TR_HOST_EMU
extern "C" int tr_setup_info(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, setup_kernel);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, setup_kernel, kThreads, 0);
}
#endif
