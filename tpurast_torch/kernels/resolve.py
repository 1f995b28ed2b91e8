"""Forward attribute resolve: the per-pixel G-buffer of the winning face.

Replaces the Pallas kernel tpurast/kernels/resolve.py::_resolve_kernel
(launched by resolve_gbuffer). The CUDA kernel is csrc/resolve.cu; the
plain torch version below computes the same bits and is what CPU tensors
take. pack_resolve_attrs is a torch op on both sides.

The reference selects each pixel's 89-float attribute row with a one-hot
HIGHEST-precision matmul per segment, which is exact selection; here each
pixel reads attrs[fid] directly. The reference's 16-level masked sums
pick exactly one level's value (or none, for a lod that is not a level
in [0, 16)), so they become one indexed read guarded by the same range.
"""

from __future__ import annotations

import torch

from tpurast_torch import kernels as _k
from tpurast_torch.kernels import _build
from tpurast_torch.kernels import shade as _shade

# Attribute-table row layout (A_IN, per face), tpurast/kernels/resolve.py:
#   0..8 edge matrix | 9,10 anchor | 11 face id | 12..17 uv | 18..26 world
#   27..35 normal | 36..51 mip offset/256 | 52,53 mip-0 w,h | 54 mip count
#   55 constant 1.0 | 56 texture id | 57..72 page base y | 73..88 page base x
A_IN = 89
# G-buffer planes (A_OUT): 0..2 world | 3..5 normal | 6,7 u,v | 8 off0/256
#   9,10 tw0,th0 | 11,12 tw1,th1 | 13 mip frac | 14,15 aniso major du,dv
#   16 matched | 17 probe span | 18 texture id | 19 l0
#   20,21 own-mip page base (y, x) | 22,23 parent-mip page base (y, x)
A_OUT = 24
# The planes that hold integers (atlas offset, mip dims, matched flag,
# texture id, l0, page bases): kernel and plain version agree on them exactly.
INT_PLANES = (8, 9, 10, 11, 12, 16, 18, 19, 20, 21, 22, 23)
MAX_MIPS = 16


def pack_resolve_attrs(setup, face_world, face_normal, face_uv, face_tex, atlas) -> torch.Tensor:
    """(F, A_IN) f32 per-face attribute table (resolve.py pack_resolve_attrs)."""
    f = setup.shape[0]
    offsets = atlas["offsets"]
    sizes = atlas["sizes"]
    n_mips = atlas["n_mips"]
    ft = face_tex.long()
    if "page_origins" in atlas:
        page_base = (atlas["page_origins"] + 1).to(torch.float32)  # (T, 16, 2)
    else:  # a scene without pages: the gather sampler reads no page base
        page_base = torch.zeros((offsets.shape[0], MAX_MIPS, 2), dtype=torch.float32, device=setup.device)
    tex_cols = torch.cat(
        [
            (offsets // 256).to(torch.float32),
            sizes[:, 0, 0:1].to(torch.float32),
            sizes[:, 0, 1:2].to(torch.float32),
            n_mips.to(torch.float32)[:, None],
        ],
        dim=1,
    )[ft]
    page_cols = torch.cat([page_base[:, :, 0], page_base[:, :, 1]], dim=1)[ft]
    return torch.cat(
        [
            setup[:, 0:9],
            setup[:, 16:18],
            setup[:, 15:16],
            face_uv.reshape(f, 6),
            face_world.reshape(f, 9),
            face_normal.reshape(f, 9),
            tex_cols,
            torch.ones((f, 1), dtype=torch.float32, device=setup.device),
            face_tex.to(torch.float32)[:, None],
            page_cols,
        ],
        dim=1,
    ).to(torch.float32).contiguous()


def _level(s, base, level):
    """s[base + level] per pixel, 0 where level is not in [0, MAX_MIPS)."""
    ok = (level >= 0.0) & (level < float(MAX_MIPS))
    idx = torch.where(ok, level, torch.zeros_like(level)).long()
    val = torch.gather(s, 0, (base + idx)[None])[0]
    return torch.where(ok, val, torch.zeros_like(val)), ok, idx


def resolve_pixels(s, px, py, max_anisotropy: int) -> list[torch.Tensor]:
    """The G-buffer planes of pixels whose attribute rows are s (A_IN, M),
    at pixel centers relative to the anchor px, py (M,). Term for term
    resolve.py:176-281."""
    e0 = s[0] * px + s[1] * py + s[2]
    e1 = s[3] * px + s[4] * py + s[5]
    e2 = s[6] * px + s[7] * py + s[8]
    esum = e0 + e1 + e2
    eps = 1e-30
    den = torch.where(
        torch.abs(esum) < eps,
        torch.where(esum < 0, torch.full_like(esum, -eps), torch.full_like(esum, eps)),
        esum,
    )
    inv = _shade.fdiv(1.0, den)
    u0, u1, u2 = e0 * inv, e1 * inv, e2 * inv

    def interp(b0, b1, b2):
        return u0 * s[b0] + u1 * s[b1] + u2 * s[b2]

    uv_u, uv_v = interp(12, 14, 16), interp(13, 15, 17)
    wx, wy, wz = interp(18, 21, 24), interp(19, 22, 25), interp(20, 23, 26)
    nx_, ny_, nz_ = interp(27, 30, 33), interp(28, 31, 34), interp(29, 32, 35)

    d_x = s[0] + s[3] + s[6]
    d_y = s[1] + s[4] + s[7]
    inv2 = inv * inv

    def duv(c0, c1, c2):
        nval = e0 * s[c0] + e1 * s[c1] + e2 * s[c2]
        gx = s[0] * s[c0] + s[3] * s[c1] + s[6] * s[c2]
        gy = s[1] * s[c0] + s[4] * s[c1] + s[7] * s[c2]
        return (gx * esum - nval * d_x) * inv2, (gy * esum - nval * d_y) * inv2

    du_dx, du_dy = duv(12, 14, 16)
    dv_dx, dv_dy = duv(13, 15, 17)

    w0, h0, n_mips = s[52], s[53], s[54]
    ax, bx = du_dx * w0, dv_dx * h0
    ay, by = du_dy * w0, dv_dy * h0
    rho2_x = ax * ax + bx * bx
    rho2_y = ay * ay + by * by
    if max_anisotropy > 1:
        rho2, maj_du, maj_dv, span = _shade.aniso_footprint(
            rho2_x, rho2_y, du_dx, du_dy, dv_dx, dv_dy, max_anisotropy
        )
    else:
        rho2 = torch.maximum(rho2_x, rho2_y)
        maj_du = torch.zeros_like(rho2)
        maj_dv = maj_du
        span = maj_du

    lod = 0.5 * torch.log2(torch.clamp(rho2, min=1e-24))
    lod = torch.minimum(torch.maximum(lod, torch.zeros_like(lod)), n_mips - 1.0)
    l0 = torch.floor(lod)
    l1 = torch.minimum(l0 + 1.0, n_mips - 1.0)
    tfrac = lod - l0

    pow2 = torch.tensor([2.0**-i for i in range(MAX_MIPS)], dtype=torch.float32, device=s.device)
    off0, ok0, i0 = _level(s, 36, l0)
    oy0, _, _ = _level(s, 57, l0)
    ox0, _, _ = _level(s, 73, l0)
    oy1, ok1, i1 = _level(s, 57, l1)
    ox1, _, _ = _level(s, 73, l1)
    pow0 = torch.where(ok0, pow2[i0], torch.zeros_like(l0))
    pow1 = torch.where(ok1, pow2[i1], torch.zeros_like(l1))
    one = torch.ones_like(l0)
    tw0 = torch.maximum(torch.floor(w0 * pow0), one)
    th0 = torch.maximum(torch.floor(h0 * pow0), one)
    tw1 = torch.maximum(torch.floor(w0 * pow1), one)
    th1 = torch.maximum(torch.floor(h0 * pow1), one)
    return [
        wx, wy, wz, nx_, ny_, nz_, uv_u, uv_v, off0, tw0, th0, tw1, th1,
        tfrac, maj_du, maj_dv, s[55], span, s[56], l0, oy0, ox0, oy1, ox1,
    ]


def _y_offset(tile_row_offset: int, tile_h: int | None) -> int:
    """The slab's first frame pixel row."""
    if tile_row_offset and not tile_h:
        raise ValueError("tile_row_offset needs tile_h")
    return tile_row_offset * tile_h if tile_row_offset else 0


def resolve_gbuffer_plain(vis, attrs, *, max_anisotropy: int = 1, tile_row_offset: int = 0,
                          tile_h: int | None = None) -> torch.Tensor:
    """Plain torch version of the resolve kernel: (A_OUT, Hp, Wp) f32,
    all zeros where vis holds no face."""
    y_offset = _y_offset(tile_row_offset, tile_h)
    _, hp, wp = vis.shape
    fid = vis[1].reshape(-1)
    pix = torch.nonzero(fid >= 0.0)[:, 0]
    out = torch.zeros((A_OUT, hp * wp), dtype=torch.float32, device=vis.device)
    if pix.numel():
        s = attrs[fid[pix].long()].T  # (A_IN, M)
        gx = (pix % wp).to(torch.float32)
        gy = (pix // wp + y_offset).to(torch.float32)
        planes = resolve_pixels(s, (gx + 0.5) - s[9], (gy + 0.5) - s[10], max_anisotropy)
        out[:, pix] = torch.stack(planes)
    return out.reshape(A_OUT, hp, wp)


def resolve_gbuffer(vis, attrs, *, max_anisotropy: int = 1, tile_row_offset: int = 0,
                    tile_h: int | None = None) -> torch.Tensor:
    """Per-pixel G-buffer (A_OUT, Hp, Wp) from the raster output vis
    (2, Hp, Wp) and the attribute table attrs (F, A_IN)
    (resolve.py resolve_gbuffer). A slab (tile_row_offset, a Python int,
    its first frame tile row, with tile_h) interpolates at the frame's
    pixel rows and writes its own. CPU tensors run the plain version;
    CUDA tensors launch csrc/resolve.cu."""
    if not _k.use_kernel(vis, attrs):
        return resolve_gbuffer_plain(vis, attrs, max_anisotropy=max_anisotropy, tile_row_offset=tile_row_offset,
                                     tile_h=tile_h)
    y_offset = _y_offset(tile_row_offset, tile_h)
    _k.check(vis, "vis", torch.float32)
    if vis.dim() != 3 or vis.shape[0] != 2:
        raise ValueError(f"vis: expected (2, H, W), got {tuple(vis.shape)}")
    _k.check(attrs, "attrs", torch.float32)
    if attrs.dim() != 2 or attrs.shape[1] != A_IN:
        raise ValueError(f"attrs: expected (F, {A_IN}), got {tuple(attrs.shape)}")
    _, hp, wp = vis.shape
    out = torch.empty((A_OUT, hp, wp), dtype=torch.float32, device=vis.device)
    _build.call("tr_resolve", vis, attrs, attrs.shape[0], hp, wp, y_offset, max_anisotropy, out)
    _k.LAUNCHES["resolve"] += 1
    return out
