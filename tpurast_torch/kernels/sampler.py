"""Texel-window plan and anisotropic trilinear texturing, plus lighting.

Replaces the two Pallas kernels of tpurast/kernels/sampler.py:
_plan_kernel (launched by plan_tiles; CUDA kernel csrc/plan.cu) and
_sampler_kernel (helper _slot_accumulate, launched by sample_tiles; CUDA
kernel csrc/sampler.cu). The plain torch versions below are what CPU
tensors take.

The plan is the reference's, value for value: per tile a greedy banded
covering of the pixels' page-space texel footprints by at most K2
windows of WH x WW texels, the tile's class (windowed, empty, residual),
each pixel's own and parent window slot, and per (chunk, slot) the y and
x bands of the window the chunk touches.

On this card the plan decides nothing about texel reads: the sample
kernel runs one pass per pixel and reads every texel straight from the
page through L1 / L2, windowed and residual tiles alike (the reference
stages the planned windows because its vector unit has no per-lane
gather). The plan stays on the main path for two things: the kernel
skips tiles of class EMPTY, and the renderer reports the matched pixels
of residual tiles (more than K2 windows) as window_miss_px, as the
reference counts its gather fallback. So the frame is that of direct
sampling whatever the plan says, and the plain version samples straight
from the page too.

The page the kernel takes is channel-interleaved: one (PH, PW, 4) bf16
array, 8 bytes a texel, built once at upload (device/scene.py). Callers
hold the (4, PH, PW) view of it (``interleave_page``), which indexes like
the reference's planar page, so the plain version and every other reader
take the same tensor; the wrapper raises on a page with other strides.

Per matched pixel
(sampler.py:763-880): n = probe_count(...) probes along the major axis at
the own mip (tw0, th0; page base planes 20/21) and at the parent mip
(tw1, th1; planes 22/23). Each probe is one bilinear tap at the wrapped
texel x0w = x0 mod w and its +1 neighbours, which lie in the rect's ghost
border (device/pages.py). The x weights are rounded to bf16 as the
reference's matmul operand is; the y weights stay f32; a tap is
sum_y ry * (sum_x cw * t) in f32. The own and parent probe sums mix as
((1 - tf) * S_own + tf * S_par) / n, then basic.frag lighting and the
blend against the clear color. Unmatched pixels get the clear color.

The reference's windowed kernel takes texel positions and bilinear
fractions relative to the window instead: x - floor(x) rounded at the
window coordinate's magnitude (a bf16 x weight moves by one bf16 ulp for
a small share of taps), and on big mips it moves a wrapped texel below
the pixel's anchored lo texel up one period into the ghost border, also
when rounding alone put the probe one texel below the anchor range
(ROADMAP queue 3). Direct positions avoid both.
"""

from __future__ import annotations

import ctypes

import torch

from tpurast_torch import kernels as _k
from tpurast_torch.kernels import _build
from tpurast_torch.kernels import shade as _shade
from tpurast_torch.kernels.resolve import A_OUT

# Repeat-addressing constants shared with the page builder's ghost-border
# sizing (tpurast/kernels/sampler.py:116-132, device/pages.py).
X_WRAP_LIM = 255.0
Y_WRAP_LIM = 87.0
WRAP_GHOST = 24

# Window plan (tpurast/kernels/sampler.py:87-182): window origins align
# to (ALIGN_Y, ALIGN_X); a window is (WH, WW) texels; a tile plans at most
# K2 windows; per (chunk, slot) the sample reads (YB, XB) bands of it.
ALIGN_Y = 8
ALIGN_X = 128
WH = 96
WW = 384
K2 = 32
YB = 48
XB = 128
NXB = WW // XB
RC = 16
CLS_WINDOWED = 0
CLS_EMPTY = 2
CLS_RESIDUAL = 3
CHUNK_NP_LANE = 120
# Pixels the plan kernel holds in registers (1024 threads x 4, csrc/plan.cu
# kGroupPx); a larger tile keeps its pixels' state in PLAN_SCRATCH_PLANES
# int planes of the frame (anchors, slots, flags).
PLAN_GROUP_PX = 4096
PLAN_SCRATCH_PLANES = 10


def rc_for(tile_h: int) -> int:
    """Chunk row height for a tile height (sampler.py rc_for)."""
    if tile_h % 8 != 0:
        raise ValueError(f"tile_h must be a multiple of 8, got {tile_h}")
    return RC if tile_h % RC == 0 else 8


def _to_tiles(x, tiles_y, tile_h, tiles_x, tile_w):
    """(..., Hp, Wp) -> (..., T, tile_h * tile_w), tiles in raster order,
    pixels row-major inside a tile."""
    lead = x.shape[:-2]
    x = x.reshape(*lead, tiles_y, tile_h, tiles_x, tile_w).movedim(-3, -2)
    return x.reshape(*lead, tiles_y * tiles_x, tile_h * tile_w)


def _from_tiles(x, tiles_y, tile_h, tiles_x, tile_w):
    """Inverse of _to_tiles."""
    lead = x.shape[:-2]
    x = x.reshape(*lead, tiles_y, tiles_x, tile_h, tile_w).movedim(-2, -3)
    return x.reshape(*lead, tiles_y * tile_h, tiles_x * tile_w)


def _probe_count(g, max_anisotropy):
    if max_anisotropy > 1:
        return _shade.probe_count(g[17], g[14], g[15], g[9], g[10], max_anisotropy)
    return torch.ones_like(g[17])


def _probe_extent_anchors(g, max_anisotropy):
    """Per-pixel page-coordinate anchor ranges, own (y_lo, y_hi, x_lo,
    x_hi) and parent, and the probe count (sampler.py
    _probe_extent_anchors)."""
    u, v = g[6], g[7]
    tw0, th0, tw1, th1 = g[9], g[10], g[11], g[12]
    span = g[17]
    n_px = _probe_count(g, max_anisotropy)
    fo_ext = (0.5 - _shade.fdiv(0.5, n_px)) * span
    du_ext = torch.abs(g[14]) * fo_ext
    dv_ext = torch.abs(g[15]) * fo_ext

    def anchor(uu, ww, dd, lim):
        lo_u = torch.floor((uu - dd) * ww - 0.5)
        hi_u = torch.floor((uu + dd) * ww - 0.5)
        ww_c = torch.clamp(ww, min=1.0)
        lo_m = torch.remainder(lo_u, ww_c)
        hi_m = torch.remainder(hi_u, ww_c)
        big = ww > lim
        lo = torch.where(big, lo_m, torch.minimum(lo_m, hi_m))
        hi = torch.where(big, lo_m + (hi_u - lo_u), torch.maximum(lo_m, hi_m))
        return lo, hi

    xo_lo, xo_hi = anchor(u, tw0, du_ext, X_WRAP_LIM)
    yo_lo, yo_hi = anchor(v, th0, dv_ext, Y_WRAP_LIM)
    xp_lo, xp_hi = anchor(u, tw1, du_ext, X_WRAP_LIM)
    yp_lo, yp_hi = anchor(v, th1, dv_ext, Y_WRAP_LIM)
    own = (yo_lo + g[20], yo_hi + g[20], xo_lo + g[21], xo_hi + g[21])
    par = (yp_lo + g[22], yp_hi + g[22], xp_lo + g[23], xp_hi + g[23])
    return own, par, n_px


def plan_tiles_plain(gbuf, *, tiles_x, tiles_y, tile_h, tile_w, max_anisotropy=1):
    """Plain torch version of the plan kernel, the dict plan_tiles
    returns; table and assign are laid out as sampler.py _plan_kernel
    writes them. All tiles run each greedy round at once; a tile whose
    covering is done stops changing."""
    dev = gbuf.device
    t_total = tiles_x * tiles_y
    rc = rc_for(tile_h)
    nc = tile_h // rc
    g = _to_tiles(gbuf, tiles_y, tile_h, tiles_x, tile_w)  # (A_OUT, T, P)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=dev)
    half_big = big * 0.5
    matched = g[16] > 0.0
    own, par, n_px = _probe_extent_anchors(g, max_anisotropy)
    anch = own + par
    unfit_o = (own[1] - own[0] > WH - ALIGN_Y - 2) | (own[3] - own[2] > WW - ALIGN_X - 2)
    unfit_p = (par[1] - par[0] > WH - ALIGN_Y - 2) | (par[3] - par[2] > WW - ALIGN_X - 2)
    unfit_any = (matched & (unfit_o | unfit_p)).any(dim=1)
    todo_o = matched & ~unfit_o
    todo_p = matched & ~unfit_p
    # A NaN or infinite anchor on a role that could be assigned (a
    # non-finite u, v, derivative or page origin under a matched pixel;
    # inf - inf is NaN, so the fit test lets it through) can place no
    # window, and the reference goes on to convert non-finite floats to
    # integers. Here such a tile is RESIDUAL with no window and no
    # assignment, in the kernel too (csrc/plan.cu).
    nan_o = ~torch.isfinite(torch.stack(own)).all(dim=0)
    nan_p = ~torch.isfinite(torch.stack(par)).all(dim=0)
    poison = ((todo_o & nan_o) | (todo_p & nan_p)).any(dim=1)
    unfit_any = unfit_any | poison
    todo_o = todo_o & ~poison[:, None]
    todo_p = todo_p & ~poison[:, None]
    n_px = torch.nan_to_num(n_px, nan=1.0)  # a NaN probe count counts as 1 in the chunk's lane
    assign_o = torch.full_like(g[0], -1.0)
    assign_p = torch.full_like(g[0], -1.0)
    share_ok = (g[11] == g[9]) & (g[12] == g[10])
    done = torch.zeros(t_total, dtype=torch.bool, device=dev)
    n_used = torch.zeros(t_total, dtype=torch.int32, device=dev)
    sl_oy = torch.zeros((t_total, K2), dtype=torch.int32, device=dev)
    sl_ox = torch.zeros((t_total, K2), dtype=torch.int32, device=dev)

    def masked_min(m0, a0, m1, a1):
        return torch.amin(torch.minimum(torch.where(m0, a0, big), torch.where(m1, a1, big)), dim=1)

    for s in range(K2):
        ymin = masked_min(todo_o, anch[0], todo_p, anch[4])
        seed = ~done & (ymin < half_big)
        done = done | (ymin >= half_big)
        if not bool(seed.any()):
            if bool(done.all()):
                break
            continue
        oy = ymin - torch.floor(ymin / ALIGN_Y) * ALIGN_Y
        lim_y = (ymin - oy + (WH - 2))[:, None]
        band_o = todo_o & (anch[1] < lim_y)
        band_p = todo_p & (anch[5] < lim_y)
        xmin = masked_min(band_o, anch[2], band_p, anch[6])
        oxs = xmin - torch.floor(xmin / ALIGN_X) * ALIGN_X
        lim_x = (xmin - oxs + (WW - 2))[:, None]
        win_o = band_o & (anch[3] < lim_x) & seed[:, None]
        win_p = band_p & (anch[7] < lim_x) & (~win_o | share_ok) & seed[:, None]
        assign_o = torch.where(win_o, float(s), assign_o)
        assign_p = torch.where(win_p, float(s), assign_p)
        todo_o = todo_o & ~win_o
        todo_p = todo_p & ~win_p
        ymin_i = torch.where(seed, ymin, 0.0).to(torch.int32)
        xmin_i = torch.where(seed, xmin, 0.0).to(torch.int32)
        sl_oy[:, s] = torch.where(seed, ymin_i - ymin_i % ALIGN_Y, 0)
        sl_ox[:, s] = torch.where(seed, xmin_i - xmin_i % ALIGN_X, 0)
        n_used = n_used + seed.to(torch.int32)

    covered = matched.any(dim=1)
    leftover = (todo_o | todo_p).any(dim=1) | unfit_any
    cls = torch.where(
        covered,
        torch.where(leftover, CLS_RESIDUAL, CLS_WINDOWED),
        CLS_EMPTY,
    ).to(torch.int32)
    table = torch.zeros((t_total, 8, 128), dtype=torch.int32, device=dev)
    table[:, 0, 0] = cls
    table[:, 0, 1] = n_used
    table[:, 0, 32 : 32 + K2] = sl_oy
    table[:, 0, 64 : 64 + K2] = sl_ox

    # Per-(chunk, slot) plan words (sampler.py:362-445).
    neg_big = -big
    cp = rc * tile_w
    for ci in range(nc):
        rows = slice(ci * cp, (ci + 1) * cp)
        ao, ap = assign_o[:, rows], assign_p[:, rows]
        m_c = matched[:, rows]
        npx_c = n_px[:, rows]
        table[:, 1 + ci, CHUNK_NP_LANE] = torch.amax(torch.where(m_c, npx_c, 1.0), dim=1).to(torch.int32)
        a = [x[:, rows] for x in anch]
        for j in range(int(n_used.max()) if t_total else 0):
            m_o = ao == float(j)
            m_p = ap == float(j)
            m_any = m_o | m_p
            use = m_any.any(dim=1) & (j < n_used)

            def vmin(lo_o, lo_p):
                r = torch.amin(torch.minimum(torch.where(m_o, lo_o, big), torch.where(m_p, lo_p, big)), dim=1)
                return torch.where(use, r, 0.0).to(torch.int32)

            def vmax(hi_o, hi_p):
                r = torch.amax(torch.maximum(torch.where(m_o, hi_o, neg_big), torch.where(m_p, hi_p, neg_big)), dim=1)
                return torch.where(use, r, 0.0).to(torch.int32)

            ylo, yhi = vmin(a[0], a[4]), vmax(a[1], a[5])
            xlo, xhi = vmin(a[2], a[6]), vmax(a[3], a[7])
            rylo = torch.clamp(ylo - sl_oy[:, j], 0, WH - 1)
            ryhi = torch.clamp(yhi - sl_oy[:, j] + 1, 0, WH - 1)
            rxlo = torch.clamp(xlo - sl_ox[:, j], 0, WW - 1)
            rxhi = torch.clamp(xhi - sl_ox[:, j] + 1, 0, WW - 1)
            b0 = rylo - rylo % ALIGN_Y
            nyb = torch.clamp(torch.div(ryhi + 1 - b0 + YB - 1, YB, rounding_mode="floor"), 1, WH // YB)
            b0 = torch.minimum(b0, WH - nyb * YB)
            xb0 = torch.div(rxlo, XB, rounding_mode="floor")
            nxb = torch.clamp(torch.div(rxhi, XB, rounding_mode="floor"), 0, NXB - 1) - xb0 + 1
            np_s = torch.clamp(torch.amax(torch.where(m_any, npx_c, 1.0), dim=1).to(torch.int32), 1, 16)
            word = 1 | (b0 << 1) | (nyb << 9) | (xb0 << 12) | (nxb << 14) | ((np_s - 1) << 16)
            table[:, 1 + ci, j] = torch.where(use, word, 0)
    assign = _from_tiles(torch.stack([assign_o, assign_p]), tiles_y, tile_h, tiles_x, tile_w)
    n_matched = matched.sum(dim=1)
    residual_px = torch.where(cls == CLS_RESIDUAL, n_matched, 0).sum().to(torch.int32)
    return _plan_dict(table, assign, residual_px)


def tap_position(i, u, v, maj_du, maj_dv, span, n_px, ww, hh, base_y, base_x):
    """Probe i's bilinear tap at one mip level: the page row and column of
    its wrapped top-left texel (int64) and its y and x fractions
    (sampler.py:817-831)."""
    fo = (_shade.fdiv(i + 0.5, n_px) - 0.5) * span
    x = (u + maj_du * fo) * ww - 0.5
    y = (v + maj_dv * fo) * hh - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    px = (base_x + torch.remainder(x0, torch.clamp(ww, min=1.0))).long()
    py = (base_y + torch.remainder(y0, torch.clamp(hh, min=1.0))).long()
    return py, px, y - y0, x - x0


def _tap_sum(page, u, v, maj_du, maj_dv, span, n_px, ww, hh, base_y, base_x, n_max):
    """Probe sum (4, M) at one mip level: sum over probes i < n_px of one
    bilinear tap each (tap_position; sampler.py:613-642 weights)."""
    acc = torch.zeros((4,) + u.shape, dtype=torch.float32, device=u.device)
    for i in range(n_max):
        py, px, fy, fx = tap_position(i, u, v, maj_du, maj_dv, span, n_px, ww, hh, base_y, base_x)
        cw1 = fx.to(torch.bfloat16).to(torch.float32)
        cw0 = (1.0 - fx).to(torch.bfloat16).to(torch.float32)
        ry0 = 1.0 - fy
        ry1 = fy
        t00 = page[:, py, px].to(torch.float32)
        t01 = page[:, py, px + 1].to(torch.float32)
        t10 = page[:, py + 1, px].to(torch.float32)
        t11 = page[:, py + 1, px + 1].to(torch.float32)
        row0 = t00 * cw0 + t01 * cw1
        row1 = t10 * cw0 + t11 * cw1
        tap = row0 * ry0 + row1 * ry1
        acc = torch.where(i < n_px, acc + tap, acc)
    return acc


def _shade_pixels(g, s_own, s_par, n_px, camera_position, *, light_direction, light_color,
                  ambient_amount, specular_power, clear_color, blend):
    """Mip blend, probe normalisation, lighting and blend of matched
    pixels (sampler.py:867-880, shade_out)."""
    tfrac = g[13]
    t_i = 1.0 - tfrac
    albedo = [_shade.fdiv(s_own[c] * t_i + s_par[c] * tfrac, n_px) for c in range(4)]
    rgb = _shade._light_planes(
        albedo,
        [g[0], g[1], g[2]],
        [g[3], g[4], g[5]],
        camera_position,
        light_direction=light_direction,
        light_color=light_color,
        ambient_amount=ambient_amount,
        specular_power=specular_power,
    )
    mask = torch.ones_like(tfrac, dtype=torch.bool)
    return torch.stack(_shade.blend_planes(rgb, 1.0, mask, clear_color, blend))


def sample_pixels(g, page, camera_position, *, max_anisotropy, **light):
    """Linear color (4, M) of matched pixels with G-buffer columns g
    (A_OUT, M), every texel read straight from the page."""
    u, v = g[6], g[7]
    maj_du, maj_dv, span = g[14], g[15], g[17]
    n_px = _probe_count(g, max_anisotropy)
    n_max = int(n_px.max()) if n_px.numel() else 0
    s_own = _tap_sum(page, u, v, maj_du, maj_dv, span, n_px, g[9], g[10], g[20], g[21], n_max)
    s_par = _tap_sum(page, u, v, maj_du, maj_dv, span, n_px, g[11], g[12], g[22], g[23], n_max)
    return _shade_pixels(g, s_own, s_par, n_px, camera_position, **light)


def sample_tiles_plain(gbuf, page, plan, camera_position, *, tiles_x, tiles_y, tile_h, tile_w,
                       max_anisotropy, light_direction, light_color, ambient_amount, specular_power,
                       clear_color, blend="alpha"):
    """Plain torch version of the sample kernel: (4, Hp, Wp) f32 linear.
    Every matched pixel is sampled straight from the page (4, PH, PW),
    whatever the plan says (the kernel skips EMPTY tiles, which hold no
    matched pixel); unmatched pixels take the clear color."""
    del plan, tiles_x, tiles_y, tile_h, tile_w
    _, hp, wp = gbuf.shape
    g = gbuf.reshape(gbuf.shape[0], -1)
    pix = torch.nonzero(g[16] > 0.0)[:, 0]
    out = torch.tensor([float(c) for c in clear_color], dtype=torch.float32, device=gbuf.device)
    out = out[:, None].repeat(1, hp * wp)
    if pix.numel():
        out[:, pix] = sample_pixels(
            g[:, pix], page, camera_position, max_anisotropy=max_anisotropy,
            light_direction=light_direction, light_color=light_color,
            ambient_amount=ambient_amount, specular_power=specular_power,
            clear_color=clear_color, blend=blend,
        )
    return out.reshape(4, hp, wp)


def _plan_dict(table, assign, residual_px):
    return {
        "table": table,
        "assign": assign,
        "cls": table[:, 0, 0],
        "n_used": table[:, 0, 1],
        "residual_px": residual_px,
    }


def plan_scratch(tile_h: int, tile_w: int, hp: int, wp: int, device):
    """The plan kernel's scratch for tiles of more than PLAN_GROUP_PX
    pixels: (PLAN_SCRATCH_PLANES, Hp, Wp) int32; None (a null pointer) for
    smaller tiles, whose state stays in registers."""
    if tile_h * tile_w <= PLAN_GROUP_PX:
        return None
    return torch.empty((PLAN_SCRATCH_PLANES, hp, wp), dtype=torch.int32, device=device)


def plan_tiles(gbuf, *, tiles_x, tiles_y, tile_h, tile_w, max_anisotropy=1):
    """Per-tile window plan (sampler.py plan_tiles) of the G-buffer
    (A_OUT, Hp, Wp). Returns a dict: "table" (T, 8, 128) i32 (row 0: class,
    slot count, window origins at lanes 32+k / 64+k; rows 1..NC: per-chunk
    plan words, lane CHUNK_NP_LANE the chunk's probe count), "assign"
    (2, Hp, Wp) f32 own/parent slot per pixel (-1 none), "cls" and
    "n_used" (views of the table) and "residual_px", the matched pixels
    of residual tiles (the reference's window_miss_px). CPU tensors run the
    plain version; CUDA tensors launch csrc/plan.cu."""
    rc = rc_for(tile_h)
    if not _k.use_kernel(gbuf):
        return plan_tiles_plain(
            gbuf, tiles_x=tiles_x, tiles_y=tiles_y, tile_h=tile_h, tile_w=tile_w,
            max_anisotropy=max_anisotropy,
        )
    _k.check(gbuf, "gbuf", torch.float32, (A_OUT, tiles_y * tile_h, tiles_x * tile_w))
    if tile_h // rc > 7:
        raise ValueError(f"the plan table holds at most 7 chunks of {rc} rows, got tile_h {tile_h}")
    t_total = tiles_x * tiles_y
    table = torch.empty((t_total, 8, 128), dtype=torch.int32, device=gbuf.device)
    assign = torch.empty((2,) + tuple(gbuf.shape[1:]), dtype=torch.float32, device=gbuf.device)
    residual_px = torch.zeros((), dtype=torch.int32, device=gbuf.device)  # the kernel adds to it
    scratch = plan_scratch(tile_h, tile_w, gbuf.shape[1], gbuf.shape[2], gbuf.device)
    _build.call("tr_plan", gbuf, tiles_x, tiles_y, tile_h, tile_w, rc, max_anisotropy, table, assign, residual_px,
                scratch)
    _k.LAUNCHES["plan"] += 1
    return _plan_dict(table, assign, residual_px)


def interleave_page(planes: torch.Tensor) -> torch.Tensor:
    """The (4, PH, PW) page as the sample kernel takes it: the same values
    in one channel-interleaved (PH, PW, 4) array, returned as its
    (4, PH, PW) view, which indexes like the planar page."""
    return planes.permute(1, 2, 0).contiguous().permute(2, 0, 1)


def _check_page(page):
    if page.dtype != torch.bfloat16:
        raise TypeError(f"page: expected torch.bfloat16, got {page.dtype}")
    if page.dim() != 3 or page.shape[0] != 4:
        raise ValueError(f"page: expected (4, PH, PW), got {tuple(page.shape)}")
    pw = page.shape[2]
    if page.stride() != (1, 4 * pw, 4) or page.data_ptr() % 8 != 0:
        raise ValueError(
            f"page: the sample kernel takes the (4, PH, PW) view of a channel-interleaved (PH, PW, 4) array "
            f"(interleave_page), strides (1, {4 * pw}, 4); got strides {page.stride()}"
        )


def sample_tiles(gbuf, page, plan, camera_position, *, tiles_x, tiles_y, tile_h, tile_w,
                 max_anisotropy, light_direction, light_color, ambient_amount, specular_power,
                 clear_color, blend="alpha", stamps=(None, None)):
    """Texture, light and blend every pixel of the G-buffer gbuf
    (A_OUT, Hp, Wp) from the bf16 page, the (4, PH, PW) view that
    interleave_page gives, with the plan from plan_tiles (read for the
    tiles' classes); camera_position (3,) f32. Returns the (4, Hp, Wp) f32
    linear framebuffer (sampler.py sample_tiles, with the residual tiles
    already shaded). CPU tensors run the plain version, on any (4, PH, PW)
    page; CUDA tensors launch csrc/sampler.cu. stamps: the (start, end) words of the frame
    trace's marks that the kernel stamps (tracing.FrameMarks.stamps), each
    a 0-dim int64 CUDA tensor or None; the plain version takes none."""
    kw = dict(
        light_direction=light_direction, light_color=light_color, ambient_amount=ambient_amount,
        specular_power=specular_power, clear_color=clear_color, blend=blend,
    )
    table = plan["table"]
    if not _k.use_kernel(gbuf, page, table, camera_position):
        return sample_tiles_plain(
            gbuf, page, plan, camera_position, tiles_x=tiles_x, tiles_y=tiles_y, tile_h=tile_h,
            tile_w=tile_w, max_anisotropy=max_anisotropy, **kw,
        )
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    _k.check(gbuf, "gbuf", torch.float32, (A_OUT, hp, wp))
    _check_page(page)
    _k.check(table, "plan table", torch.int32, (tiles_x * tiles_y, 8, 128))
    _k.check(camera_position, "camera_position", torch.float32, (3,))
    params = (ctypes.c_float * _shade.N_PARAMS)(*_shade.shade_params(**kw))
    out = torch.empty((4, hp, wp), dtype=torch.float32, device=gbuf.device)
    _build.call(
        "tr_sample", gbuf, page, page.shape[2], table, camera_position,
        tiles_x, tiles_y, tile_h, tile_w, max_anisotropy, ctypes.addressof(params), out, *stamps,
    )
    _k.LAUNCHES["sample"] += 1
    return out
