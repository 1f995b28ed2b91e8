"""The reference frame: plain torch, float32, the reference renderer's rules.

One frame of a RefScene from one pose, computed without anything of the
program: the corners to clip space, triangle setup with back-face and
off-screen culling, every (tile, face) pair of every visible face, the
visibility raster (anchored edge functions at pixel centres, top-left
fill, reversed-Z greater-or-equal, ties to the later face), each covered
pixel's interpolated attributes and UV derivatives, the anisotropic
footprint and mip choice, the texture filtering of the configuration's
path, basic.frag's lighting, the alpha blend over the clear colour and
the sRGB encode. The expressions and their order are those of the port's
plain torch versions (tpurast_torch/kernels/*.py), frozen here: its
kernels are held to those bit for bit, so an honest frame lands within
one LSB of this one.

Texels are read straight from each texture's mip pyramid with repeat
addressing, in the form the configuration stores them:

  page   the window sampler's texels, linear float rounded to bfloat16;
         a probe is a bilinear tap at the own mip and one at the parent
         mip, the two probe sums mixed by the mip fraction;
  srgb8  the row atlas' texels, sRGB-encoded 8-bit colour and linear
         8-bit alpha, decoded by the EOTF; a probe is the own mip's 2 x 2
         quad and the parent mip's 3 x 3 window around it, mixed per
         probe (deferred shading, and the gather sampler);
  float16 the row atlas' texels as float16, filtered as srgb8.

``texel_store`` is where a control computes a lower precision.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from portbench.reference import math3d as m3
from portbench.reference.scene import RefScene

MAX_MIPS = 16


@dataclasses.dataclass(frozen=True)
class Target:
    """The render target and the renderer's settings the frame needs."""

    width: int
    height: int
    tile_h: int = 32
    tile_w: int = 128
    vfov_deg: float = 80.0
    znear: float = 0.01
    clear_color: tuple = (1.0, 0.0, 1.0, 1.0)
    clear_depth: float = 0.0
    light_color: tuple = (0.86, 0.65, 0.35)
    light_direction: tuple = (1.0, -1.0, 1.0)
    ambient_amount: float = 0.1
    specular_power: float = 32.0
    max_anisotropy: int = 16

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def light_dir(self) -> tuple:
        x, y, z = self.light_direction
        n = math.sqrt(x * x + y * y + z * z)
        return (x / n, y / n, z / n)


def target_of(config: dict, renderer: dict) -> Target:
    """The Target of a configuration file's size and its renderer settings
    (RendererConfig fields; the defaults are the reference renderer's)."""
    keep = {f.name for f in dataclasses.fields(Target)}
    return Target(width=config["width"], height=config["height"],
                  **{k: tuple(v) if isinstance(v, list) else v for k, v in renderer.items() if k in keep})


# -- the scene on the device ----------------------------------------------


@dataclasses.dataclass
class DeviceRef:
    corner_world: torch.Tensor
    corner_normal: torch.Tensor
    corner_uv: torch.Tensor
    face_tex: torch.Tensor
    n_faces: int
    texels: torch.Tensor  # (N, 4) f32: every (texture, mip) texel as stored and decoded
    mip_off: torch.Tensor  # (T, MAX_MIPS) i64 first texel of each mip in texels (the last mip repeated)
    base_w: torch.Tensor  # (T,) f32 mip-0 width
    base_h: torch.Tensor  # (T,) f32
    n_mips: torch.Tensor  # (T,) f32
    fmt: str


def _srgb8_bounds():
    mid = (np.arange(1, 256, dtype=np.float64) - 0.5) / 255.0
    srgb = np.where(mid <= 0.04045, mid / 12.92, ((mid + 0.055) / 1.055) ** 2.4).astype(np.float32)
    lin = ((np.arange(1, 256) - 0.5) / 255.0).astype(np.float32)
    return torch.from_numpy(srgb), torch.from_numpy(lin)


def srgb8_encode(linear: torch.Tensor) -> torch.Tensor:
    """(N, 4) linear f32 in [0, 1] -> (N, 4) u8: colour sRGB-encoded and
    alpha linear, each to the nearest code (u8 k where x >= EOTF((k - 0.5)
    / 255))."""
    b_srgb, b_lin = (b.to(linear.device) for b in _srgb8_bounds())
    x = linear.clamp(0.0, 1.0)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    out[:, :3] = torch.searchsorted(b_srgb, x[:, :3].contiguous()).to(torch.uint8)
    out[:, 3] = torch.searchsorted(b_lin, x[:, 3].contiguous()).to(torch.uint8)
    return out


def srgb8_decode(c8: torch.Tensor) -> torch.Tensor:
    """(N, 4) u8 -> f32: colour through the sRGB EOTF, alpha / 255."""
    c = c8.to(torch.float32) * (1.0 / 255.0)
    rgb = torch.where(c[:, :3] <= 0.04045, c[:, :3] * (1.0 / 12.92),
                      torch.pow((c[:, :3] + 0.055) * (1.0 / 1.055), 2.4))
    return torch.cat([rgb, c[:, 3:]], dim=1)


def texel_store(linear: torch.Tensor, fmt: str, lower: bool = False) -> torch.Tensor:
    """Linear f32 texels (N, 4) as the configuration stores them and the
    sampler reads them back. ``lower`` takes the next lower precision, the
    control: bfloat16 and float16 -> float8 (e4m3), 8-bit codes -> their top
    4 bits."""
    if fmt == "page":
        dt = torch.float8_e4m3fn if lower else torch.bfloat16
        return linear.to(dt).to(torch.float32)
    if fmt == "float16":
        return linear.to(torch.float8_e4m3fn if lower else torch.float16).to(torch.float32)
    if fmt == "srgb8":
        c8 = srgb8_encode(linear)
        if lower:
            c8 = (c8 & 0xF0) | 0x08
        return srgb8_decode(c8)
    raise ValueError(f"unknown texel format {fmt!r}")


def to_device(scene: RefScene, fmt: str, device, lower: bool = False) -> DeviceRef:
    dev = torch.device(device)
    n_tex = len(scene.textures)
    mip_off = np.zeros((n_tex, MAX_MIPS), dtype=np.int64)
    chunks, cursor = [], 0
    for t, mips in enumerate(scene.textures):
        for lvl in range(MAX_MIPS):
            if lvl < len(mips):
                mip_off[t, lvl] = cursor
                cursor += mips[lvl].shape[0] * mips[lvl].shape[1]
                chunks.append(mips[lvl].reshape(-1, 4))
            else:
                mip_off[t, lvl] = mip_off[t, len(mips) - 1]
    texels = torch.empty((cursor, 4), dtype=torch.float32, device=dev)
    at = 0
    for c in chunks:  # one mip at a time: the stored form is made on the device
        texels[at : at + c.shape[0]] = texel_store(torch.from_numpy(c).to(dev), fmt, lower)
        at += c.shape[0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return DeviceRef(
        corner_world=t(scene.corner_world), corner_normal=t(scene.corner_normal), corner_uv=t(scene.corner_uv),
        face_tex=t(scene.face_tex.astype(np.int64)), n_faces=scene.n_faces, texels=texels, mip_off=t(mip_off),
        base_w=t(np.array([m[0].shape[1] for m in scene.textures], np.float32)),
        base_h=t(np.array([m[0].shape[0] for m in scene.textures], np.float32)),
        n_mips=t(np.array([len(m) for m in scene.textures], np.float32)), fmt=fmt,
    )


# -- geometry ----------------------------------------------------------------


def fdiv(a, b) -> torch.Tensor:
    """One correctly rounded division, whichever operand is a number."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    elif not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.div(a, b)


def transform_corners(corner_world, view_proj):
    """(F, 3, 3) -> (F, 3, 4) clip: (x m0 + y m1) + (z m2 + m3)."""
    f = corner_world.shape[0]
    w = corner_world.reshape(f * 3, 3)
    m = view_proj
    clip = (w[:, 0:1] * m[:, 0] + w[:, 1:2] * m[:, 1]) + (w[:, 2:3] * m[:, 2] + m[:, 3])
    return clip.reshape(f, 3, 4)


def _cross(a, b):
    """cross(a, b), each component one rounding of p q - r s."""
    a64, b64 = a.double(), b.double()

    def comp(i, j):
        return (a64[:, i] * b64[:, j] - (a[:, j] * b[:, i]).double()).float()

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def triangle_setup(c, n_faces: int, width: int, height: int):
    """Per-face edge functions anchored at a rounded corner, depth and w
    rows, screen AABB, validity (in range, finite, front-facing, partly in
    front of the eye, on screen) and ``cut``: a corner's w at or below the
    eye plane's epsilon, which makes the face's box the whole screen."""
    dev = c.device
    nf = c.shape[0]
    w = c[..., 3]
    vx = (c[..., 0] + w) * (width * 0.5)
    vy = (w - c[..., 1]) * (height * 0.5)
    w_ok = w > 1e-20
    one = torch.ones_like(w)
    sx = torch.where(w_ok, vx / torch.where(w_ok, w, one), torch.zeros_like(w))
    sy = torch.where(w_ok, vy / torch.where(w_ok, w, one), torch.zeros_like(w))
    first_ok = torch.argmax(w_ok.to(torch.int8), dim=-1)
    ax = torch.round(torch.gather(sx, 1, first_ok[:, None])[:, 0])
    ay = torch.round(torch.gather(sy, 1, first_ok[:, None])[:, 0])
    any_ok = w_ok.any(dim=-1)
    zero = torch.zeros_like(ax)
    ax = torch.where(any_ok, torch.clamp(ax, -4 * width, 5 * width), zero)
    ay = torch.where(any_ok, torch.clamp(ay, -4 * height, 5 * height), zero)
    v = torch.stack([vx - ax[:, None] * w, vy - ay[:, None] * w, w], dim=-1)
    e0, e1, e2 = _cross(v[:, 1], v[:, 2]), _cross(v[:, 2], v[:, 0]), _cross(v[:, 0], v[:, 1])
    p = e0 * v[:, 0]
    det = (p[:, 0] + p[:, 1]) + p[:, 2]
    ids = torch.arange(nf, device=dev)
    valid = (ids < n_faces) & torch.isfinite(c.reshape(nf, -1)).all(dim=-1) & (det < 0.0) & any_ok
    any_behind = ~w_ok.all(dim=-1)
    big = torch.full_like(sx, 1e9)
    minx = torch.where(any_behind, zero, torch.where(w_ok, sx, big).amin(dim=-1))
    miny = torch.where(any_behind, zero, torch.where(w_ok, sy, big).amin(dim=-1))
    maxx = torch.where(any_behind, torch.full_like(zero, float(width)), torch.where(w_ok, sx, -big).amax(dim=-1))
    maxy = torch.where(any_behind, torch.full_like(zero, float(height)), torch.where(w_ok, sy, -big).amax(dim=-1))
    valid = valid & (maxx >= 0.0) & (maxy >= 0.0) & (minx < width) & (miny < height)
    rows = torch.cat([e0, e1, e2, c[..., 2], w, ax[:, None], ay[:, None]], dim=-1).to(torch.float32)
    return dict(rows=rows, valid=valid, aabb=torch.stack([minx, miny, maxx, maxy], dim=-1), cut=any_behind)


# Columns of triangle_setup's rows.
R_E = 0  # 9 edge coefficients
R_Z = 9
R_W = 12
R_AX, R_AY = 15, 16


def tile_pairs(aabb, valid, t: Target):
    """Every (tile, face) pair of the visible faces: each face with every
    tile its AABB overlaps. Returns (pair_tile, pair_face) int64."""

    def div(a, b):
        return a / torch.full_like(a, b)

    tx0 = torch.floor(div(aabb[:, 0], t.tile_w))
    ty0 = torch.floor(div(aabb[:, 1], t.tile_h))
    tx1 = torch.floor(div(aabb[:, 2], t.tile_w))
    ty1 = torch.floor(div(aabb[:, 3], t.tile_h))
    ok = valid & (tx1 >= 0.0) & (ty1 >= 0.0) & (tx0 < t.tiles_x) & (ty0 < t.tiles_y)
    tx0, tx1 = (torch.clamp(v, 0, t.tiles_x - 1).long() for v in (tx0, tx1))
    ty0, ty1 = (torch.clamp(v, 0, t.tiles_y - 1).long() for v in (ty0, ty1))
    span_x = tx1 - tx0 + 1
    span = torch.where(ok, span_x * (ty1 - ty0 + 1), torch.zeros_like(span_x))
    face = torch.repeat_interleave(torch.arange(aabb.shape[0], device=aabb.device), span)
    j = torch.arange(face.numel(), device=aabb.device) - torch.repeat_interleave(torch.cumsum(span, 0) - span, span)
    sx = span_x[face]
    return (ty0[face] + j // sx) * t.tiles_x + tx0[face] + j % sx, face


def pixel_rects(aabb):
    """Each face's inclusive pixel bounds: floor(min) - 1 .. floor(max) + 1."""
    return torch.cat([torch.floor(aabb[:, 0:2]) - 1.0, torch.floor(aabb[:, 2:4]) + 1.0], dim=1)


def _edge_covered(e, a, b):
    return (e < 0.0) | ((e == 0.0) & ((a < 0.0) | ((a == 0.0) & (b < 0.0))))


def _fragments(rows, px, py):
    def f(i):
        return rows[:, i : i + 1]

    pxr, pyr = px - f(R_AX), py - f(R_AY)
    e0 = pxr * f(0) + pyr * f(1) + f(2)
    e1 = pxr * f(3) + pyr * f(4) + f(5)
    e2 = pxr * f(6) + pyr * f(7) + f(8)
    crossing = (f(12) <= 0.0) | (f(13) <= 0.0) | (f(14) <= 0.0)
    cov_n = _edge_covered(e0, f(0), f(1)) & _edge_covered(e1, f(3), f(4)) & _edge_covered(e2, f(6), f(7))
    cov_p = crossing & _edge_covered(-e0, -f(0), -f(1)) & _edge_covered(-e1, -f(3), -f(4)) & \
        _edge_covered(-e2, -f(6), -f(7))
    esum = e0 + e1 + e2
    ez = e0 * f(9) + e1 * f(10) + e2 * f(11)
    ew = e0 * f(12) + e1 * f(13) + e2 * f(14)
    z = ez / torch.where(ew == 0.0, torch.full_like(ew, 1e-30), ew)
    return (cov_n | cov_p) & ((ew * esum) > 0.0) & (z >= 0.0) & (z <= 1.0), z


def raster(rows, aabb, pair_tile, pair_face, t: Target, step_evals: int = 2048 * 4096):
    """(depth, face id) planes (Hp, Wp): the largest depth wins, then the
    largest face id; -1 where no face covers the pixel."""
    dev = rows.device
    th, tw = t.tile_h, t.tile_w
    hp, wp = t.tiles_y * th, t.tiles_x * tw
    rects = pixel_rects(aabb)
    clear_bits = int(np.float32(t.clear_depth + 0.0).view(np.int32))
    best = torch.full((hp * wp,), clear_bits << 32, dtype=torch.int64, device=dev)
    lin = torch.arange(th * tw, device=dev)
    loc_x, loc_y = (lin % tw)[None, :], (lin // tw)[None, :]
    step = max(1, step_evals // (th * tw))
    for s in range(0, pair_face.numel(), step):
        tiles = pair_tile[s : s + step][:, None]
        faces = pair_face[s : s + step]
        gx = (tiles % t.tiles_x) * tw + loc_x
        gy = (tiles // t.tiles_x) * th + loc_y
        fx, fy = gx.to(torch.float32), gy.to(torch.float32)
        covered, z = _fragments(rows[faces], fx + 0.5, fy + 0.5)
        r = rects[faces]
        covered &= (fx >= r[:, 0:1]) & (fy >= r[:, 1:2]) & (fx <= r[:, 2:3]) & (fy <= r[:, 3:4])
        zbits = (z + 0.0).view(torch.int32).to(torch.int64)
        key = torch.where(covered, (zbits << 32) | (faces[:, None] + 1), torch.full_like(zbits, -1))
        best.scatter_reduce_(0, (gy * wp + gx).reshape(-1), key.reshape(-1), "amax")
    return (best >> 32).to(torch.int32).view(torch.float32).reshape(hp, wp), \
        ((best & 0xFFFFFFFF) - 1).reshape(hp, wp)


# -- per-pixel attributes and footprint ------------------------------------------


def aniso_footprint(rho2_x, rho2_y, du_dx, du_dy, dv_dx, dv_dy, n: int):
    rho2_max = torch.maximum(rho2_x, rho2_y)
    rho2_used = torch.maximum(torch.minimum(rho2_x, rho2_y), rho2_max * (1.0 / (n * n)))
    ratio_c = torch.clamp(torch.sqrt(fdiv(rho2_max, torch.clamp(rho2_used, min=1e-24))), 1.0, float(n))
    span = 1.0 - fdiv(1.0, ratio_c)
    major_is_x = rho2_x >= rho2_y
    return rho2_used, torch.where(major_is_x, du_dx, du_dy), torch.where(major_is_x, dv_dx, dv_dy), span


def probe_count(span, maj_du, maj_dv, tw0, th0, n: int):
    ext = torch.maximum(torch.abs(maj_du) * tw0, torch.abs(maj_dv) * th0) * span
    return torch.clamp(torch.ceil(ext - 1e-4), 1.0, float(n))


def pixel_fields(dr: DeviceRef, rows, fid_flat, pix, wp: int, ma: int) -> dict:
    """The covered pixels' interpolated world position, normal and uv, the
    UV derivatives' anisotropic footprint, the mip pair and fraction and
    the probe count. pix: flat indices into the (Hp, Wp) frame."""
    f = fid_flat[pix]
    s = rows[f].T  # (17, M)
    px = ((pix % wp).to(torch.float32) + 0.5) - s[R_AX]
    py = ((pix // wp).to(torch.float32) + 0.5) - s[R_AY]
    e0 = s[0] * px + s[1] * py + s[2]
    e1 = s[3] * px + s[4] * py + s[5]
    e2 = s[6] * px + s[7] * py + s[8]
    esum = e0 + e1 + e2
    eps = 1e-30
    den = torch.where(torch.abs(esum) < eps, torch.where(esum < 0, torch.full_like(esum, -eps),
                                                         torch.full_like(esum, eps)), esum)
    inv = fdiv(1.0, den)
    u0, u1, u2 = e0 * inv, e1 * inv, e2 * inv
    cw, cn, cu = dr.corner_world[f], dr.corner_normal[f], dr.corner_uv[f]

    def interp(c, k):
        return u0 * c[:, 0, k] + u1 * c[:, 1, k] + u2 * c[:, 2, k]

    world = [interp(cw, k) for k in range(3)]
    normal = [interp(cn, k) for k in range(3)]
    uv_u, uv_v = interp(cu, 0), interp(cu, 1)
    d_x = s[0] + s[3] + s[6]
    d_y = s[1] + s[4] + s[7]
    inv2 = inv * inv

    def duv(k):
        c0, c1, c2 = cu[:, 0, k], cu[:, 1, k], cu[:, 2, k]
        nval = e0 * c0 + e1 * c1 + e2 * c2
        gx = s[0] * c0 + s[3] * c1 + s[6] * c2
        gy = s[1] * c0 + s[4] * c1 + s[7] * c2
        return (gx * esum - nval * d_x) * inv2, (gy * esum - nval * d_y) * inv2

    du_dx, du_dy = duv(0)
    dv_dx, dv_dy = duv(1)
    tex = dr.face_tex[f]
    w0, h0, n_mips = dr.base_w[tex], dr.base_h[tex], dr.n_mips[tex]
    ax, bx = du_dx * w0, dv_dx * h0
    ay, by = du_dy * w0, dv_dy * h0
    rho2_x = ax * ax + bx * bx
    rho2_y = ay * ay + by * by
    if ma > 1:
        rho2, maj_du, maj_dv, span = aniso_footprint(rho2_x, rho2_y, du_dx, du_dy, dv_dx, dv_dy, ma)
    else:
        rho2 = torch.maximum(rho2_x, rho2_y)
        maj_du = maj_dv = span = torch.zeros_like(rho2)
    lod = 0.5 * torch.log2(torch.clamp(rho2, min=1e-24))
    lod = torch.minimum(torch.maximum(lod, torch.zeros_like(lod)), n_mips - 1.0)
    l0 = torch.floor(lod)
    l1 = torch.minimum(l0 + 1.0, n_mips - 1.0)
    one = torch.ones_like(l0)
    pow2 = torch.tensor([2.0**-i for i in range(MAX_MIPS)], dtype=torch.float32, device=l0.device)
    p0, p1 = pow2[l0.long()], pow2[l1.long()]
    tw0 = torch.maximum(torch.floor(w0 * p0), one)
    th0 = torch.maximum(torch.floor(h0 * p0), one)
    tw1 = torch.maximum(torch.floor(w0 * p1), one)
    th1 = torch.maximum(torch.floor(h0 * p1), one)
    n_px = probe_count(span, maj_du, maj_dv, tw0, th0, ma) if ma > 1 else one
    return dict(world=world, normal=normal, u=uv_u, v=uv_v, tex=tex, l0=l0.long(), l1=l1.long(), tfrac=lod - l0,
                tw0=tw0, th0=th0, tw1=tw1, th1=th1, maj_du=maj_du, maj_dv=maj_dv, span=span, n_px=n_px,
                n_mips=n_mips.long())


def probe_offset(i: int, g: dict):
    return (fdiv(i + 0.5, g["n_px"]) - 0.5) * g["span"]


def _index(dr: DeviceRef, tex, lvl, y, x, w):
    return dr.mip_off[tex, lvl] + y * w + x


def _texel(dr: DeviceRef, tex, lvl, y, x, w):
    return dr.texels[_index(dr, tex, lvl, y, x, w)]  # (M, 4)


def page_taps(dr: DeviceRef, g: dict, i: int, own: bool, record=None, live=None):
    """Probe i's bilinear tap (M, 4) at the own or parent mip: x weights
    rounded to bfloat16, y weights float32. record(texel indices) is told
    the four texels of each live tap."""
    lvl, ww, hh = (g["l0"], g["tw0"], g["th0"]) if own else (g["l1"], g["tw1"], g["th1"])
    fo = probe_offset(i, g)
    x = (g["u"] + g["maj_du"] * fo) * ww - 0.5
    y = (g["v"] + g["maj_dv"] * fo) * hh - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    wi, hi = ww.long(), hh.long()
    xa = torch.remainder(x0, torch.clamp(ww, min=1.0)).long()
    ya = torch.remainder(y0, torch.clamp(hh, min=1.0)).long()
    xb, yb = (xa + 1) % wi, (ya + 1) % hi
    if record is not None:
        for yy, xx in ((ya, xa), (ya, xb), (yb, xa), (yb, xb)):
            record(_index(dr, g["tex"], lvl, yy, xx, wi)[live])
    cw1 = fx.to(torch.bfloat16).to(torch.float32)
    cw0 = (1.0 - fx).to(torch.bfloat16).to(torch.float32)
    tex = g["tex"]
    row0 = _texel(dr, tex, lvl, ya, xa, wi) * cw0 + _texel(dr, tex, lvl, ya, xb, wi) * cw1
    row1 = _texel(dr, tex, lvl, yb, xa, wi) * cw0 + _texel(dr, tex, lvl, yb, xb, wi) * cw1
    return row0 * (1.0 - fy) + row1 * fy


def page_albedo(dr: DeviceRef, g: dict, ma: int, record=None):
    """The window sampler: per mip the sum of the probes' taps, mixed by
    the mip fraction, over the probe count."""
    n_max = int(g["n_px"].max()) if g["n_px"].numel() else 0
    acc = [torch.zeros((g["u"].numel(), 4), dtype=torch.float32, device=g["u"].device) for _ in range(2)]
    for i in range(n_max):
        live = (i < g["n_px"])[:, None]
        for k, own in enumerate((True, False)):
            acc[k] = torch.where(live, acc[k] + page_taps(dr, g, i, own, record, live[:, 0]), acc[k])
    t_i = (1.0 - g["tfrac"])[:, None]
    return fdiv(acc[0] * t_i + acc[1] * g["tfrac"][:, None], g["n_px"][:, None])


def row_probe(dr: DeviceRef, g: dict, u, v, record=None, live=None):
    """One trilinear probe from the row atlas' texels: the own mip's 2 x 2
    quad and the parent mip's 3 x 3 window anchored at ((x0 - 1) // 2,
    (y0 - 1) // 2), the parent footprint at offset 0 or 1 in it.
    record(row indices) is told the row (the own quad) of each live probe."""
    tex, l0 = g["tex"], g["l0"]
    tw0, th0 = g["tw0"], g["th0"]
    x = u * tw0 - 0.5
    y = v * th0 - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    wi, hi = tw0.long(), th0.long()
    x0i = torch.remainder(x0.to(torch.int32).long(), torch.clamp(wi, min=1))
    y0i = torch.remainder(y0.to(torch.int32).long(), torch.clamp(hi, min=1))
    if record is not None:
        record(_index(dr, tex, l0, y0i, x0i, wi) if live is None else _index(dr, tex, l0, y0i, x0i, wi)[live])
    xb, yb = (x0i + 1) % wi, (y0i + 1) % hi
    q = [_texel(dr, tex, l0, y0i, x0i, wi), _texel(dr, tex, l0, y0i, xb, wi),
         _texel(dr, tex, l0, yb, x0i, wi), _texel(dr, tex, l0, yb, xb, wi)]
    x1f = u * g["tw1"] - 0.5
    y1f = v * g["th1"] - 0.5
    x1, y1 = torch.floor(x1f), torch.floor(y1f)
    fx1, fy1 = x1f - x1, y1f - y1
    dx = torch.clamp(x1 - torch.floor((x0 - 1.0) * 0.5), 0.0, 1.0)
    dy = torch.clamp(y1 - torch.floor((y0 - 1.0) * 0.5), 0.0, 1.0)
    wx1 = [(1.0 - dx) * (1.0 - fx1), (1.0 - dx) * fx1 + dx * (1.0 - fx1), dx * fx1]
    wy1 = [(1.0 - dy) * (1.0 - fy1), (1.0 - dy) * fy1 + dy * (1.0 - fy1), dy * fy1]
    # The parent window: zeros on the last mip, where the mip fraction is 0.
    has_parent = (l0 + 1) < g["n_mips"]
    lp = torch.where(has_parent, l0 + 1, l0)
    w1 = torch.clamp(wi // 2, min=1)
    h1 = torch.clamp(hi // 2, min=1)
    bx = torch.div(x0i - 1, 2, rounding_mode="floor")
    by = torch.div(y0i - 1, 2, rounding_mode="floor")
    win = []
    for r in range(3):
        for c in range(3):
            t = _texel(dr, tex, lp, torch.remainder(by + r, h1), torch.remainder(bx + c, w1), w1)
            win.append(torch.where(has_parent[:, None], t, torch.zeros_like(t)))
    w9 = [(wy1[r] * wx1[c])[:, None] for r in range(3) for c in range(3)]
    top = q[0] * (1.0 - fx) + q[1] * fx
    bot = q[2] * (1.0 - fx) + q[3] * fx
    c0 = top * (1.0 - fy) + bot * fy
    c1 = w9[0] * win[0]
    for k in range(1, 9):
        c1 = c1 + w9[k] * win[k]
    return c0 * (1.0 - g["tfrac"])[:, None] + c1 * g["tfrac"][:, None]


def row_albedo(dr: DeviceRef, g: dict, ma: int, record=None):
    """Deferred shading's probe train: each live probe's trilinear sample
    summed, over the probe count."""
    if ma <= 1:
        return row_probe(dr, g, g["u"], g["v"], record)
    acc = torch.zeros((g["u"].numel(), 4), dtype=torch.float32, device=g["u"].device)
    for i in range(ma):
        live = (g["n_px"] > float(i))[:, None]
        fo = probe_offset(i, g)
        p = row_probe(dr, g, g["u"] + g["maj_du"] * fo, g["v"] + g["maj_dv"] * fo, record, live[:, 0])
        acc = acc + torch.where(live, p, torch.zeros_like(p))
    return fdiv(acc, g["n_px"][:, None])


# -- lighting, blend, encode --------------------------------------------------


def _rnorm3(x, y, z):
    return fdiv(1.0, torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-20)))


def light(albedo, g: dict, camera_position, t: Target):
    """basic.frag: ambient + Lambert diffuse on the albedo, Phong specular
    scaled by the albedo's alpha (the specular mask). Returns (M, 3)."""
    ldx, ldy, ldz = t.light_dir
    normal, world = g["normal"], g["world"]
    rn = _rnorm3(*normal)
    nx, ny, nz = normal[0] * rn, normal[1] * rn, normal[2] * rn
    vx = camera_position[0] - world[0]
    vy = camera_position[1] - world[1]
    vz = camera_position[2] - world[2]
    rv = _rnorm3(vx, vy, vz)
    vx, vy, vz = vx * rv, vy * rv, vz * rv
    n_dot_l = nx * ldx + ny * ldy + nz * ldz
    diffuse = torch.clamp(n_dot_l, min=0.0)
    rx, ry, rz = 2.0 * n_dot_l * nx - ldx, 2.0 * n_dot_l * ny - ldy, 2.0 * n_dot_l * nz - ldz
    v_dot_r = torch.clamp(vx * rx + vy * ry + vz * rz, min=0.0)
    spec = albedo[:, 3] * torch.pow(v_dot_r, float(t.specular_power))
    k = t.ambient_amount + diffuse
    lc = [float(c) for c in t.light_color]
    return torch.stack([(k * lc[i]) * albedo[:, i] + spec * lc[i] for i in range(3)], dim=1)


def encode_srgb_u8(planes, width: int, height: int):
    fb = torch.clamp(planes[:, :height, :width], 0.0, 1.0)
    rgb = torch.where(fb[:3] <= 0.0031308, fb[:3] * 12.92, 1.055 * torch.pow(fb[:3], 1.0 / 2.4) - 0.055)
    return torch.round(torch.cat([rgb, fb[3:4]], dim=0) * 255.0).to(torch.uint8)


# -- the frame ----------------------------------------------------------------------


@dataclasses.dataclass
class Frame:
    color: torch.Tensor  # (4, H, W) u8
    covered: int  # pixels of the frame a face covers
    stats: dict  # the work the frame needs (portbench/yardstick.py)


def render(dr: DeviceRef, t: Target, position, target, want_stats: bool = False) -> Frame:
    """The frame from the pose (position, target), sampled as dr.fmt says:
    the page (the window sampler) or the row atlas (gather, deferred)."""
    dev = dr.texels.device
    vp, cp = m3.frame_uniforms(position, target, t.width, t.height, math.radians(t.vfov_deg), t.znear)
    view_proj, cam = torch.from_numpy(vp).to(dev), torch.from_numpy(cp).to(dev)
    setup = triangle_setup(transform_corners(dr.corner_world, view_proj), dr.n_faces, t.width, t.height)
    pair_tile, pair_face = tile_pairs(setup["aabb"], setup["valid"], t)
    depth, fid = raster(setup["rows"], setup["aabb"], pair_tile, pair_face, t)
    hp, wp = depth.shape
    fid_flat = fid.reshape(-1)
    pix = torch.nonzero(fid_flat >= 0)[:, 0]
    g = pixel_fields(dr, setup["rows"], fid_flat, pix, wp, t.max_anisotropy)
    stats, record = {}, None
    if want_stats:
        from portbench import yardstick

        stats = yardstick.frame_work(setup, pair_tile, pair_face, fid_flat, pix, g, t, dr)
        touched = torch.zeros(dr.texels.shape[0], dtype=torch.bool, device=dev)
        record = functools.partial(touched.index_fill_, 0, value=True)
    if dr.fmt == "page":
        albedo = page_albedo(dr, g, t.max_anisotropy, record)
    else:
        albedo = row_albedo(dr, g, t.max_anisotropy, record)
    if want_stats:
        stats["distinct"] = int(touched.sum())
    rgb = light(albedo, g, cam, t)
    out = torch.tensor([float(c) for c in t.clear_color], dtype=torch.float32, device=dev)[:, None].repeat(1, hp * wp)
    out[:3, pix] = rgb.T
    return Frame(color=encode_srgb_u8(out.reshape(4, hp, wp), t.width, t.height), covered=int(pix.numel()),
                 stats=stats)


def texel_format(scene: RefScene, fields: dict) -> str:
    """Where the frame's texels come from, by the configuration's renderer
    fields: "page" for forward shading with the window sampler (the
    default), else the row atlas in its texel dtype; "auto" takes srgb8
    where float16 rows would pass 2 GiB and every texel is in [0, 1],
    float16 elsewhere."""
    if fields.get("shading", "forward") == "forward" and fields.get("sampler", "auto") in ("auto", "window"):
        return "page"
    dtype = fields.get("texture_dtype", "auto")
    if dtype != "auto":
        return dtype
    rows = 0
    for mips in scene.textures:
        for m in mips:
            rows += (-rows) % 256 + m.shape[0] * m.shape[1]
    ldr = max(float(m.max()) for mips in scene.textures for m in mips) <= 1.0 + 1e-6
    return "srgb8" if rows * 52 * 2 > 2 << 30 and ldr else "float16"
