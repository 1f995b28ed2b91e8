"""Shading: lighting, blend, footprint, and the row-atlas gather paths.

Counterpart of tpurast/kernels/shade.py, same names, same operation
order. The lighting, blend and footprint formulas (_rnorm3,
_light_planes, blend_planes, aniso_footprint, probe_count) are shared by
the plain versions of the resolve and sample kernels; csrc/resolve.cu,
csrc/sampler.cu and csrc/shade.cu repeat them term for term
(csrc/shading.cuh holds the lighting and blend they share).

The gather sampler (shade_gbuffer, the forward path's shading tail) and
deferred shading (shade_deferred) read the quad-row
atlas (device/textures.py): one (N, 52) row per trilinear sample holds
the own-mip 2x2 quad and the parent mip's 3x3 window (_trilerp). The
reference leaves both to XLA (shade.py:316, :463); here each is a CUDA
kernel of csrc/shade.cu (tr_shade_gbuffer, tr_shade_deferred): one
thread per pixel that runs only its own probes. The plain versions
(shade_gbuffer_plain, shade_deferred_plain) keep the reference's form,
every probe of max_anisotropy over every pixel, masked, and are what CPU
tensors and plain_kernels() take. Kernel and plain version run the same
_trilerp on the same values, so a forward+gather frame equals the
deferred frame bit for bit on either.

A face's shading row (pack_shade_rows, 104 floats) is the frame's setup
row (24 floats) beside 80 that depend on the scene alone: the per-scene
table (scene_table), built once when the scene is uploaded
(device/scene.py face_tables). The deferred kernel reads each pixel's face
row from the setup rows and that table, so no frame builds the packed
table; the plain version takes the packed table, which join_shade_rows
puts together from the same two parts.

Two places differ from jnp by necessity, on pixels whose color the blend
discards: an integer modulus by a texture width of 0 (an uncovered
forward pixel) is taken at 1, where torch would raise, and gather rows
are clamped into the table, as JAX clamps an out-of-range gather index
where torch would fault.

Every division goes through ``fdiv``: torch's CUDA division by a CPU
scalar multiplies by the scalar's reciprocal, and ``scalar / tensor`` is
``tensor.reciprocal() * scalar`` everywhere; both round differently from
the true division the kernels (and the reference) compute.
"""

from __future__ import annotations

import ctypes

import torch

from tpurast_torch import kernels as _k
from tpurast_torch.kernels import _build
from tpurast_torch.kernels.geometry import SETUP_WIDTH as _SETUP_WIDTH

# Fat-row layout of the per-face shading table (pack_shade_rows):
# [setup(24) | world(9) | normal(9) | uv(6) | tex-info(49, int32 bits) | 0 pad]
ROW_WORLD = _SETUP_WIDTH
ROW_NORMAL = _SETUP_WIDTH + 9
ROW_UV = _SETUP_WIDTH + 18
ROW_TEXINFO = _SETUP_WIDTH + 24
SHADE_ROW_WIDTH = 104
# The per-scene table's row: the shading row's columns ROW_WORLD.. (80
# floats, so each row starts on the 16-byte grid).
TABLE_WIDTH = SHADE_ROW_WIDTH - _SETUP_WIDTH
# Texture-info row (int32): [offsets(16) | widths(16) | heights(16) | n_mips]
TEX_ROW_WIDTH = 49
MAX_MIPS = 16
# Shading parameters the kernels take (csrc/shading.cuh ShadeParams), in
# shade_params' order.
N_PARAMS = 13
# csrc/shade.cu's code of each atlas row dtype (device/textures.py
# texels_tensor), and the texel_format it goes with.
ROW_FORMATS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.uint8: 3}


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


def shade_params(*, light_direction, light_color, ambient_amount, specular_power, clear_color, blend):
    """The N_PARAMS floats the sample and shade kernels take: light
    direction (3), light color (3), ambient, specular power, clear color
    (4), opaque flag."""
    if blend not in ("alpha", "opaque"):
        raise ValueError(f"unknown blend mode {blend!r}")
    vals = [*light_direction, *light_color, ambient_amount, specular_power, *clear_color,
            1.0 if blend == "opaque" else 0.0]
    if len(vals) != N_PARAMS:
        raise ValueError("light_direction/light_color need 3 entries, clear_color 4")
    return vals


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


def pack_tex_table(atlas) -> torch.Tensor:
    """(TEX, 49) int32: per-texture mip offsets, widths, heights and mip
    count (shade.py pack_tex_table)."""
    sizes = atlas["sizes"]
    return torch.cat(
        [
            atlas["offsets"].to(torch.int32),
            sizes[..., 0].to(torch.int32),
            sizes[..., 1].to(torch.int32),
            atlas["n_mips"].to(torch.int32)[:, None],
        ],
        dim=1,
    )


def scene_table(face_world, face_normal, face_uv, face_tex, atlas) -> torch.Tensor:
    """(F, TABLE_WIDTH) f32 per-scene table: the shading row's columns
    ROW_WORLD.. (world, normal, uv, the texture info and the padding). The
    int32 texture info rides in the f32 row by bit reinterpretation
    (Tensor.view), not conversion: offsets exceed f32's integer range."""
    f = face_world.shape[0]
    tex_rows = pack_tex_table(atlas)[face_tex.long()].contiguous()
    return torch.cat(
        [
            face_world.reshape(f, 9),
            face_normal.reshape(f, 9),
            face_uv.reshape(f, 6),
            tex_rows.view(torch.float32),
            torch.zeros((f, SHADE_ROW_WIDTH - ROW_TEXINFO - TEX_ROW_WIDTH), dtype=torch.float32,
                        device=face_world.device),
        ],
        dim=1,
    )


def join_shade_rows(setup, table) -> torch.Tensor:
    """(F, 104) f32 shading table from the (F, 24) setup rows and the
    (F, TABLE_WIDTH) scene_table: the rows the deferred kernel reads."""
    return torch.cat([setup, table], dim=1)


def pack_shade_rows(setup, face_world, face_normal, face_uv, face_tex, atlas) -> torch.Tensor:
    """(F, 104) f32 per-face shading table (shade.py pack_shade_rows): the
    setup rows beside scene_table's columns."""
    return join_shade_rows(setup, scene_table(face_world, face_normal, face_uv, face_tex, atlas))


def _safe_div(a, b, eps=1e-30):
    """a / b with |b| raised to eps, sign kept (shade.py _safe_div)."""
    den = torch.where(
        torch.abs(b) < eps,
        torch.where(b < 0, torch.full_like(b, -eps), torch.full_like(b, eps)),
        b,
    )
    return fdiv(a, den)


def _srgb_texel(c8: torch.Tensor) -> torch.Tensor:
    """An sRGB-encoded u8 texel plane decoded to linear f32 with the exact
    piecewise EOTF (shade.py _trilerp, texel_format="srgb8"). The
    constants are f32 and multiply, as the reference's do."""
    c = c8.to(torch.float32) * (1.0 / 255.0)
    return torch.where(c <= 0.04045, c * (1.0 / 12.92), torch.pow((c + 0.055) * (1.0 / 1.055), 2.4))


def _trilerp(texels, off0, tw0, th0, tw1, th1, tfrac, u, v, texel_format: str = "float"):
    """Trilinear sample with repeat addressing from ONE atlas row per pixel
    (shade.py _trilerp): the row at the own mip's quad (x0, y0) holds the
    2x2 bilinear quad and the parent mip's 3x3 window anchored at
    ((x0-1)//2, (y0-1)//2), in which the parent footprint sits at offset
    dx, dy in {0, 1}. Returns the 4 planes (r, g, b, a) shaped like u."""
    if texel_format not in ("float", "srgb8"):
        raise ValueError(f"unknown texel format {texel_format!r}")
    wf = tw0.to(torch.float32)
    hf = th0.to(torch.float32)
    x = u * wf - 0.5
    y = v * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.remainder(x0.to(torch.int32), torch.clamp(tw0, min=1))
    y0i = torch.remainder(y0.to(torch.int32), torch.clamp(th0, min=1))
    idx = torch.clamp(off0 + y0i * tw0 + x0i, 0, texels.shape[0] - 1)
    # The gathered rows, channel-planar and contiguous: (52, ...).
    row = texels[idx.long()].movedim(-1, 0).contiguous()

    wf1 = tw1.to(torch.float32)
    hf1 = th1.to(torch.float32)
    x1f = u * wf1 - 0.5
    y1f = v * hf1 - 0.5
    x1 = torch.floor(x1f)
    y1 = torch.floor(y1f)
    fx1 = x1f - x1
    fy1 = y1f - y1
    dx = torch.clamp(x1 - torch.floor((x0 - 1.0) * 0.5), 0.0, 1.0)
    dy = torch.clamp(y1 - torch.floor((y0 - 1.0) * 0.5), 0.0, 1.0)

    wx1 = [(1.0 - dx) * (1.0 - fx1), (1.0 - dx) * fx1 + dx * (1.0 - fx1), dx * fx1]
    wy1 = [(1.0 - dy) * (1.0 - fy1), (1.0 - dy) * fy1 + dy * (1.0 - fy1), dy * fy1]
    w9 = [wy1[r] * wx1[c] for r in range(3) for c in range(3)]
    fx_i = 1.0 - fx
    fy_i = 1.0 - fy
    t_i = 1.0 - tfrac

    def tex(i):
        if texel_format == "srgb8":
            return row[i].to(torch.float32) * (1.0 / 255.0) if i % 4 == 3 else _srgb_texel(row[i])
        return row[i].to(torch.float32)

    out = []
    for c in range(4):
        top = tex(c) * fx_i + tex(4 + c) * fx
        bot = tex(8 + c) * fx_i + tex(12 + c) * fx
        c0 = top * fy_i + bot * fy
        c1 = w9[0] * tex(16 + c)
        for k in range(1, 9):
            c1 = c1 + w9[k] * tex(16 + 4 * k + c)
        out.append(c0 * t_i + c1 * tfrac)
    return out


def _plane_select(planes, lane):
    """planes (16, ...) at a per-element level index, 0 where the index is
    not in [0, 16) (shade.py _plane_select: its masked sum picks one
    level or none, so a gather on the level axis gives the same values)."""
    ok = (lane >= 0) & (lane < MAX_MIPS)
    sel = torch.gather(planes, 0, torch.where(ok, lane, 0).long()[None])[0]
    return torch.where(ok, sel, torch.zeros_like(sel))


def _probe_albedo(n: int, npx, span, maj_du, maj_dv, uv_u, uv_v, trilinear_at):
    """The anisotropic probe train (shade.py:438-444, :518-524): probe i
    of n at ((i + 0.5)/npx - 0.5) * span along the major axis, counted
    where i < npx, and the sum divided by npx. One probe's rows are alive
    at a time."""
    acc = [torch.zeros_like(uv_u) for _ in range(4)]
    for i in range(n):
        live = npx > float(i)
        fo = (fdiv(i + 0.5, npx) - 0.5) * span
        probe = trilinear_at(uv_u + maj_du * fo, uv_v + maj_dv * fo)
        acc = [a + torch.where(live, p, 0.0) for a, p in zip(acc, probe)]
        del probe
    return [fdiv(a, npx) for a in acc]


def _light_and_blend(albedo, world, normal, mask, camera_position, *, light_direction, light_color,
                     ambient_amount, specular_power, clear_color, blend):
    """basic.frag lighting, fragment alpha 1.0, then the blend stage
    against the clear color: (4, ...) f32 planes."""
    rgb = _light_planes(
        albedo, world, normal, camera_position, light_direction=light_direction,
        light_color=light_color, ambient_amount=ambient_amount, specular_power=specular_power,
    )
    return torch.stack(blend_planes(rgb, 1.0, mask, clear_color, blend), dim=0)


def shade_deferred_plain(
    fid,
    shade_rows,
    texels,
    camera_position,
    *,
    light_direction,
    light_color,
    ambient_amount: float,
    specular_power: float,
    clear_color,
    max_anisotropy: int = 1,
    y_offset=0,
    blend: str = "alpha",
    texel_format: str = "float",
):
    """Deferred shading (shade.py shade_deferred): fid (H, W) int32 face
    id (-1 background), shade_rows (F, 104) from pack_shade_rows, texels
    (N, 52) atlas rows, camera_position (3,) f32. Each pixel gathers its
    face's row, re-evaluates the edge functions at its center (pixel rows
    offset by y_offset), interpolates, derives the UV screen gradients,
    picks the mip from the row's texture info and samples the atlas.
    Returns the (4, H, W) f32 linear framebuffer."""
    h, w = fid.shape
    dev = fid.device
    mask = fid >= 0
    f = torch.clamp(fid, min=0).long()
    # Channel-planar (104, H, W) rows: one gather per table column.
    rows = shade_rows.T.contiguous()[:, f]
    px = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5) - rows[16]
    # The row offset as an f32 fill (an integer below 2^24, so exact), not
    # a tensor built from host data: a frame captured into a CUDA graph
    # copies nothing from the host.
    y0 = torch.full((), float(y_offset), dtype=torch.float32, device=dev)
    py = ((torch.arange(h, dtype=torch.float32, device=dev)[:, None] + y0) + 0.5) - rows[17]
    e0 = rows[0] * px + rows[1] * py + rows[2]
    e1 = rows[3] * px + rows[4] * py + rows[5]
    e2 = rows[6] * px + rows[7] * py + rows[8]
    esum = e0 + e1 + e2
    inv_esum = _safe_div(1.0, esum)
    u0 = e0 * inv_esum
    u1 = e1 * inv_esum
    u2 = e2 * inv_esum

    def interp(base, k):
        return u0 * rows[base] + u1 * rows[base + k] + u2 * rows[base + 2 * k]

    world = [interp(ROW_WORLD + i, 3) for i in range(3)]
    normal = [interp(ROW_NORMAL + i, 3) for i in range(3)]
    uv_u = interp(ROW_UV, 2)
    uv_v = interp(ROW_UV + 1, 2)

    a0, a1, a2 = rows[0], rows[3], rows[6]
    b0, b1, b2 = rows[1], rows[4], rows[7]
    d_x = a0 + a1 + a2
    d_y = b0 + b1 + b2
    inv2 = inv_esum * inv_esum

    def duv(c0, c1, c2):
        n = e0 * c0 + e1 * c1 + e2 * c2
        nx = a0 * c0 + a1 * c1 + a2 * c2
        ny = b0 * c0 + b1 * c1 + b2 * c2
        return (nx * esum - n * d_x) * inv2, (ny * esum - n * d_y) * inv2

    du_dx, du_dy = duv(rows[ROW_UV], rows[ROW_UV + 2], rows[ROW_UV + 4])
    dv_dx, dv_dy = duv(rows[ROW_UV + 1], rows[ROW_UV + 3], rows[ROW_UV + 5])

    trow = rows[ROW_TEXINFO : ROW_TEXINFO + TEX_ROW_WIDTH].view(torch.int32)  # (49, H, W)
    w0 = trow[16].to(torch.float32)
    h0 = trow[32].to(torch.float32)
    n_mips = trow[48]
    last = (n_mips - 1).to(torch.float32)
    ax, bx = du_dx * w0, dv_dx * h0
    ay, by = du_dy * w0, dv_dy * h0
    rho2_x = ax * ax + bx * bx
    rho2_y = ay * ay + by * by

    def level_fields(lvl):
        return (_plane_select(trow[0:16], lvl), _plane_select(trow[16:32], lvl),
                _plane_select(trow[32:48], lvl))

    def clamped_lod(rho2):
        lod = 0.5 * torch.log2(torch.clamp(rho2, min=1e-24))
        return torch.minimum(torch.maximum(lod, torch.zeros_like(lod)), last)

    def trilinear_fields(rho2):
        # shade.py trilinear(): the level fields are the same for every
        # probe of a pixel, so they are taken once.
        lod = clamped_lod(rho2)
        l0 = torch.floor(lod).to(torch.int32)
        l1 = torch.minimum(l0 + 1, n_mips - 1)
        tfrac = lod - l0.to(torch.float32)
        off0, tw0, th0 = level_fields(l0)
        _, tw1, th1 = level_fields(l1)
        return off0, tw0, th0, tw1, th1, tfrac

    light = dict(light_direction=light_direction, light_color=light_color, ambient_amount=ambient_amount,
                 specular_power=specular_power, clear_color=clear_color, blend=blend)
    if max_anisotropy <= 1:
        fields = trilinear_fields(torch.maximum(rho2_x, rho2_y))
        albedo = _trilerp(texels, *fields, uv_u, uv_v, texel_format)
    else:
        n = int(max_anisotropy)
        rho2_used, maj_du, maj_dv, span = aniso_footprint(rho2_x, rho2_y, du_dx, du_dy, dv_dx, dv_dy, n)
        _, tw0_pc, th0_pc = level_fields(torch.floor(clamped_lod(rho2_used)).to(torch.int32))
        npx = probe_count(span, maj_du, maj_dv, tw0_pc, th0_pc, n)
        fields = trilinear_fields(rho2_used)
        albedo = _probe_albedo(
            n, npx, span, maj_du, maj_dv, uv_u, uv_v,
            lambda u, v: _trilerp(texels, *fields, u, v, texel_format),
        )
    return _light_and_blend(albedo, world, normal, mask, camera_position, **light)


def shade_gbuffer_plain(
    gbuf,
    texels,
    camera_position,
    *,
    light_direction,
    light_color,
    ambient_amount: float,
    specular_power: float,
    clear_color,
    max_anisotropy: int = 1,
    blend: str = "alpha",
    texel_format: str = "float",
):
    """The forward path's gather shading tail (shade.py shade_gbuffer):
    texture taps from the atlas rows at the G-buffer's (A_OUT, H, W)
    mip fields, then lighting and blend, in shade_deferred's formulas and
    operation order. Returns (4, H, W) f32 linear planes."""
    mask = gbuf[16] > 0.0
    world = [gbuf[0], gbuf[1], gbuf[2]]
    normal = [gbuf[3], gbuf[4], gbuf[5]]
    uv_u, uv_v = gbuf[6], gbuf[7]
    # Offsets ride through f32 as offset/256 (exact); mip dims are small
    # integers in f32.
    off0 = gbuf[8].to(torch.int32) * 256
    tw0 = gbuf[9].to(torch.int32)
    th0 = gbuf[10].to(torch.int32)
    tw1 = gbuf[11].to(torch.int32)
    th1 = gbuf[12].to(torch.int32)
    tfrac = gbuf[13]
    maj_du, maj_dv = gbuf[14], gbuf[15]
    span = gbuf[17]

    def trilinear_at(u, v):
        return _trilerp(texels, off0, tw0, th0, tw1, th1, tfrac, u, v, texel_format)

    if max_anisotropy <= 1:
        albedo = trilinear_at(uv_u, uv_v)
    else:
        n = int(max_anisotropy)
        npx = probe_count(span, maj_du, maj_dv, gbuf[9], gbuf[10], n)
        albedo = _probe_albedo(n, npx, span, maj_du, maj_dv, uv_u, uv_v, trilinear_at)
    return _light_and_blend(
        albedo, world, normal, mask, camera_position, light_direction=light_direction,
        light_color=light_color, ambient_amount=ambient_amount, specular_power=specular_power,
        clear_color=clear_color, blend=blend,
    )


def srgb_table(device) -> torch.Tensor:
    """(256,) f32: _srgb_texel of every u8 value, made on ``device`` by the
    plain version's own ops. csrc/shade.cu decodes srgb8 rows through it;
    the scene upload makes it once, beside the rows (device/scene.py,
    atlas["srgb_lut"])."""
    return _srgb_texel(torch.arange(256, dtype=torch.uint8, device=device))


def _check_rows(texels, texel_format: str, srgb_lut):
    """The atlas rows, texel format and srgb8 decode table as csrc/shade.cu
    takes them: (the rows' format code, the table or None)."""
    if texel_format not in ("float", "srgb8"):
        raise ValueError(f"unknown texel format {texel_format!r}")
    code = ROW_FORMATS.get(texels.dtype)
    if code is None or (code == ROW_FORMATS[torch.uint8]) != (texel_format == "srgb8"):
        raise TypeError(f"texels: {texels.dtype} rows do not go with texel_format={texel_format!r}")
    if texels.dim() != 2 or texels.shape[1] != 52 or texels.shape[0] < 1:
        raise ValueError(f"texels: expected (N >= 1, 52), got {tuple(texels.shape)}")
    if not texels.is_contiguous():
        raise ValueError("texels: must be contiguous")
    align = 8 if code == ROW_FORMATS[torch.uint8] else 16  # csrc/shade.cu reads rows in 16- or 8-byte loads
    if texels.data_ptr() % align:
        raise ValueError(f"texels: {texels.dtype} rows must start on a {align}-byte boundary")
    if code == 3:
        if srgb_lut is None:
            raise ValueError("srgb8 rows need srgb_lut, srgb_table's (256,) f32 table on their device")
        _k.check(srgb_lut, "srgb_lut", torch.float32, (256,))
        if srgb_lut.device != texels.device:
            raise ValueError(f"srgb_lut: on {srgb_lut.device}, the rows on {texels.device}")
        return code, srgb_lut
    return code, None


def _check_face_rows(setup, table):
    """The (F, 24) setup rows and (F, TABLE_WIDTH) scene_table as
    csrc/shade.cu takes them: f32, contiguous, each on the 16-byte grid of
    its loads."""
    for t, name, width in ((setup, "setup", _SETUP_WIDTH), (table, "table", TABLE_WIDTH)):
        _k.check(t, name, torch.float32)
        if t.dim() != 2 or t.shape != (setup.shape[0], width):
            raise ValueError(f"{name}: expected ({setup.shape[0]}, {width}), got {tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must start on a 16-byte boundary (the kernel reads its rows in 16-byte loads)")


def shade_gbuffer(gbuf, texels, camera_position, *, light_direction, light_color, ambient_amount: float,
                  specular_power: float, clear_color, max_anisotropy: int = 1, blend: str = "alpha",
                  texel_format: str = "float", srgb_lut=None, stamps=(None, None)):
    """The forward path's gather shading tail (shade.py shade_gbuffer) of
    the (A_OUT, H, W) G-buffer gbuf from the (N, 52) atlas rows texels:
    (4, H, W) f32 linear planes. CPU tensors run shade_gbuffer_plain;
    CUDA tensors launch csrc/shade.cu's tr_shade_gbuffer, which decodes
    srgb8 rows through srgb_lut (srgb_table's). stamps: the (start, end) words of the frame
    trace's marks that the kernel stamps (tracing.FrameMarks.stamps), each
    a 0-dim int64 CUDA tensor or None; the plain version takes none."""
    light = dict(light_direction=light_direction, light_color=light_color, ambient_amount=ambient_amount,
                 specular_power=specular_power, clear_color=clear_color, blend=blend)
    if not _k.use_kernel(gbuf, texels, camera_position):
        return shade_gbuffer_plain(gbuf, texels, camera_position, max_anisotropy=max_anisotropy,
                                   texel_format=texel_format, **light)
    _k.check(gbuf, "gbuf", torch.float32)
    if gbuf.dim() != 3 or gbuf.shape[0] < 18:
        raise ValueError(f"gbuf: expected (>= 18, H, W), got {tuple(gbuf.shape)}")
    _k.check(camera_position, "camera_position", torch.float32, (3,))
    code, lut = _check_rows(texels, texel_format, srgb_lut)
    _, h, w = gbuf.shape
    params = (ctypes.c_float * N_PARAMS)(*shade_params(**light))
    out = torch.empty((4, h, w), dtype=torch.float32, device=gbuf.device)
    _build.call("tr_shade_gbuffer", gbuf, texels, texels.shape[0], code, lut, camera_position, h, w,
                int(max_anisotropy), ctypes.addressof(params), out, *stamps)
    _k.LAUNCHES["gather"] += 1
    return out


def shade_deferred(fid, setup, table, texels, camera_position, *, light_direction, light_color,
                   ambient_amount: float, specular_power: float, clear_color, max_anisotropy: int = 1,
                   y_offset=0, blend: str = "alpha", texel_format: str = "float", srgb_lut=None,
                   stamps=(None, None)):
    """Deferred shading (shade.py shade_deferred) of the (H, W) f32 face
    ids fid as the raster writes them (vis[1], -1 background) from the
    frame's (F, 24) setup rows, the scene's (F, TABLE_WIDTH) scene_table
    and the (N, 52) atlas rows, pixel rows offset by y_offset (a slab's
    first frame row, a Python int): (4, H, W) f32 linear planes. CPU
    tensors run shade_deferred_plain on join_shade_rows(setup, table);
    CUDA tensors launch csrc/shade.cu's tr_shade_deferred (srgb_lut as
    shade_gbuffer's), which reads both where they lie. stamps: the (start, end) words of the frame
    trace's marks that the kernel stamps (tracing.FrameMarks.stamps), each
    a 0-dim int64 CUDA tensor or None; the plain version takes none."""
    light = dict(light_direction=light_direction, light_color=light_color, ambient_amount=ambient_amount,
                 specular_power=specular_power, clear_color=clear_color, blend=blend)
    if not _k.use_kernel(fid, setup, table, texels, camera_position):
        return shade_deferred_plain(fid.to(torch.int32), join_shade_rows(setup, table), texels, camera_position,
                                    max_anisotropy=max_anisotropy, y_offset=y_offset, texel_format=texel_format,
                                    **light)
    _k.check(fid, "fid", torch.float32)
    if fid.dim() != 2:
        raise ValueError(f"fid: expected (H, W), got {tuple(fid.shape)}")
    _check_face_rows(setup, table)
    _k.check(camera_position, "camera_position", torch.float32, (3,))
    code, lut = _check_rows(texels, texel_format, srgb_lut)
    h, w = fid.shape
    params = (ctypes.c_float * N_PARAMS)(*shade_params(**light))
    out = torch.empty((4, h, w), dtype=torch.float32, device=fid.device)
    _build.call("tr_shade_deferred", fid, setup, table, setup.shape[0], texels, texels.shape[0], code, lut,
                camera_position, h, w, int(y_offset), int(max_anisotropy), ctypes.addressof(params), out, *stamps)
    _k.LAUNCHES["deferred"] += 1
    return out
