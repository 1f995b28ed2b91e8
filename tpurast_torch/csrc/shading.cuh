// The shading tail shared by the kernels that texture a pixel (sampler.cu,
// shade.cu): the probe count of the anisotropic footprint, basic.frag
// lighting and the framebuffer blend. Term for term
// tpurast_torch/kernels/shade.py (probe_count, _light_planes,
// blend_planes with source alpha 1).
#pragma once

#include "common.cuh"

// The N_PARAMS floats of kernels/shade.py::shade_params, unpacked on the
// host and passed by value.
struct ShadeParams {
  float light_direction[3];
  float light_color[3];
  float ambient;
  float specular_power;
  float clear[4];
  float opaque;
};

inline ShadeParams read_shade_params(const float* q) {
  ShadeParams prm;
  for (int i = 0; i < 3; ++i) prm.light_direction[i] = *q++;
  for (int i = 0; i < 3; ++i) prm.light_color[i] = *q++;
  prm.ambient = *q++;
  prm.specular_power = *q++;
  for (int i = 0; i < 4; ++i) prm.clear[i] = *q++;
  prm.opaque = *q++;
  return prm;
}

__device__ __forceinline__ float rnorm3(float x, float y, float z) {
  return 1.0f / sqrtf(max_nan(x * x + y * y + z * z, 1e-20f));
}

// shade.probe_count
__device__ __forceinline__ float probe_count(float maj_du, float maj_dv, float tw0, float th0, float span,
                                             int max_anisotropy) {
  if (max_anisotropy <= 1) return 1.0f;
  const float ext = max_nan(fabsf(maj_du) * tw0, fabsf(maj_dv) * th0) * span;
  return min_nan(max_nan(ceilf(ext - 1e-4f), 1.0f), (float)max_anisotropy);
}

// The clear color at pixel p of the (4, H, W) framebuffer out.
__device__ __forceinline__ void store_clear(const ShadeParams& prm, long long plane, long long p,
                                            float* __restrict__ out) {
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c * plane + p] = prm.clear[c];
}

// Lighting (shade._light_planes, basic.frag:15-38) of a covered pixel with
// world position g[0..2], normal g[3..5] and albedo [r, g, b, specular
// mask], then the blend against the clear color (shade.blend_planes with
// source alpha 1: rgb * 1 + clear * 0; "opaque" selects).
__device__ __forceinline__ void light_store(const float g[6], const float albedo[4], const float* __restrict__ cam,
                                            const ShadeParams& prm, long long plane, long long p,
                                            float* __restrict__ out) {
  const float ldx = prm.light_direction[0], ldy = prm.light_direction[1], ldz = prm.light_direction[2];
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
    out[c * plane + p] = prm.opaque != 0.0f ? rgb : rgb * 1.0f + prm.clear[c] * 0.0f;
  }
  out[3 * plane + p] = prm.opaque != 0.0f ? 1.0f : prm.clear[3];
}
