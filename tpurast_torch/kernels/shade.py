"""Lighting, blend and texture-footprint formulas as torch ops.

Counterpart of tpurast/kernels/shade.py (_rnorm3, _light_planes,
blend_planes, aniso_footprint, probe_count), same names, same operation
order. The plain versions of the resolve and sample kernels call these;
csrc/resolve.cu and csrc/sampler.cu repeat them term for term.

Every division goes through ``fdiv``: torch's CUDA division by a CPU
scalar multiplies by the scalar's reciprocal, and ``scalar / tensor`` is
``tensor.reciprocal() * scalar`` everywhere; both round differently from
the true division the kernels (and the reference) compute.
"""

from __future__ import annotations

import torch


def fdiv(a, b) -> torch.Tensor:
    """a / b with one correctly rounded division, whichever operand is a
    Python number."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    elif not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def _rnorm3(x, y, z):
    """1/||(x,y,z)||, zero-safe: 1/sqrt, not torch.rsqrt, whose CUDA
    version is an approximation."""
    return fdiv(1.0, torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-20)))


def _light_planes(
    albedo,
    world,
    normal,
    camera_position,
    *,
    light_direction,
    light_color,
    ambient_amount: float,
    specular_power: float,
):
    """basic.frag:15-38 lighting, channel-planar (shade.py _light_planes).
    albedo [r, g, b, a] (a = specular mask), world and normal [x, y, z]
    planes, camera_position (3,) f32. Returns [r, g, b]."""
    ldx, ldy, ldz = (float(c) for c in light_direction)
    rn = _rnorm3(*normal)
    nx, ny, nz = normal[0] * rn, normal[1] * rn, normal[2] * rn
    vx = camera_position[0] - world[0]
    vy = camera_position[1] - world[1]
    vz = camera_position[2] - world[2]
    rv = _rnorm3(vx, vy, vz)
    vx, vy, vz = vx * rv, vy * rv, vz * rv

    n_dot_l = nx * ldx + ny * ldy + nz * ldz
    diffuse_amount = torch.clamp(n_dot_l, min=0.0)
    rx = 2.0 * n_dot_l * nx - ldx
    ry = 2.0 * n_dot_l * ny - ldy
    rz = 2.0 * n_dot_l * nz - ldz
    v_dot_r = torch.clamp(vx * rx + vy * ry + vz * rz, min=0.0)
    spec_amount = albedo[3] * torch.pow(v_dot_r, float(specular_power))
    k = ambient_amount + diffuse_amount
    lc = [float(c) for c in light_color]
    return [(k * lc[i]) * albedo[i] + spec_amount * lc[i] for i in range(3)]


def blend_planes(rgb, src_alpha: float, mask, clear, mode: str = "alpha"):
    """Framebuffer blend (shade.py blend_planes): "alpha" is
    src*srcAlpha + dst*(1-srcAlpha) on color and dst alpha kept;
    "opaque" selects. dst is the clear color; uncovered pixels keep it."""
    clear = [float(c) for c in clear]
    if mode == "opaque":
        planes = [torch.where(mask, rgb[i], torch.full_like(rgb[i], clear[i])) for i in range(3)]
        return planes + [torch.where(mask, torch.ones_like(rgb[0]), torch.full_like(rgb[0], clear[3]))]
    if mode != "alpha":
        raise ValueError(f"unknown blend mode {mode!r}")
    one_minus = 1.0 - src_alpha
    planes = [
        torch.where(mask, rgb[i] * src_alpha + clear[i] * one_minus, torch.full_like(rgb[i], clear[i]))
        for i in range(3)
    ]
    return planes + [torch.full_like(rgb[0], clear[3])]


def aniso_footprint(rho2_x, rho2_y, du_dx, du_dy, dv_dx, dv_dy, n: int):
    """Ratio-clamped anisotropic footprint (shade.py aniso_footprint).
    Returns (rho2_used, maj_du, maj_dv, span)."""
    rho2_max = torch.maximum(rho2_x, rho2_y)
    rho2_min = torch.minimum(rho2_x, rho2_y)
    rho2_used = torch.maximum(rho2_min, rho2_max * (1.0 / (n * n)))
    ratio = torch.sqrt(fdiv(rho2_max, torch.clamp(rho2_used, min=1e-24)))
    ratio_c = torch.clamp(ratio, 1.0, float(n))
    span = 1.0 - fdiv(1.0, ratio_c)
    major_is_x = rho2_x >= rho2_y
    maj_du = torch.where(major_is_x, du_dx, du_dy)
    maj_dv = torch.where(major_is_x, dv_dx, dv_dy)
    return rho2_used, maj_du, maj_dv, span


def probe_count(span, maj_du, maj_dv, tw0, th0, n: int):
    """Per-pixel anisotropic probe count in [1, n], as f32 (shade.py
    probe_count): ceil of the probe train's Chebyshev texel length at the
    selected own mip."""
    ext = torch.maximum(torch.abs(maj_du) * tw0, torch.abs(maj_dv) * th0) * span
    return torch.clamp(torch.ceil(ext - 1e-4), 1.0, float(n))
