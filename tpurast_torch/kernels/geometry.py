"""Geometry stage: corner transform, triangle setup, binning.

Counterpart of tpurast/kernels/geometry.py (transform_corners,
triangle_setup, _tile_ranges, bin_pairs, bin_triangles), same layouts and
field numbering. The reference leaves all of them to XLA. For CUDA
tensors the port runs the transform and the setup as one CUDA kernel
(setup_faces: csrc/setup.cu, ``LAUNCHES["setup"]``) and the binners as
others (csrc/bin.cu, ``LAUNCHES["bin"]``); the torch code below is their
plain version, which CPU tensors and kernels.plain_kernels() take, and
which the JAX parity tests hold to the reference.

Every expression keeps the reference's operation order, with one
rounding per operation. Eager torch never contracts a*b+c into an FMA on
the CPU or on the card, so the CPU tests and the card compute the same
bits here, and the kernels repeat the same operations. The one place
written as an FMA on purpose is the adjugate's cross products (see
_cross).

Divisions by a Python number go through a tensor divisor: torch's CUDA
division turns a CPU-scalar divisor into a multiply by its reciprocal,
which rounds differently from a true division.
"""

from __future__ import annotations

import torch

from tpurast_torch import kernels as _k
from tpurast_torch.kernels import _build

# Per-face setup row (tpurast/kernels/geometry.py SETUP_WIDTH):
# [E(9), z_clip(3), w_clip(3), face_id, anchor_x, anchor_y, ymin, ymax, pad].
SETUP_WIDTH = 24
FIELD_FACE_ID = 15
FIELD_ANCHOR_X = 16
FIELD_ANCHOR_Y = 17
FIELD_YMIN = 18
FIELD_YMAX = 19

# Binning defaults (tpurast/kernels/geometry.py TILES_PER_FACE, HUGE_BUDGET).
TILES_PER_FACE = 8
HUGE_BUDGET = 64
# y-bucket slots per tile key (geometry.py bin_pairs: key = tile*YB + ybucket).
YB = 1024
# Face ids ride the low FACE_BITS bits of the one int64 sort key: any int32
# id fits. The tile key (tile * YB + ybucket) rides the 32 bits above them,
# so tiles * YB must stay under 2^32 (_expand_pairs raises past it).
FACE_BITS = 31
TILE_KEY_BITS = 63 - FACE_BITS

# Near-plane boxes (near_boxes, csrc/bin.cu near_box). A face with a corner
# at w <= EYE_EPS (triangle_setup's test) is cut by the eye plane; the raster
# covers only its part where depth = z / w <= 1, so its tiles are those of the
# part on the near side of the plane w = NEAR_K * z, a little nearer the eye
# than depth 1, projected, clamped to +-NEAR_CLAMP px and widened by
# NEAR_SLOPE of each bound plus NEAR_PAD px. A face whose corners pass
# NEAR_MAX, or whose |w| passes NEAR_RATIO times its least z (where the
# raster's depth could round across the slack), keeps the full screen.
EYE_EPS = 1e-20
NEAR_K = 0.875
NEAR_RATIO = 65536.0
NEAR_MAX = 2.0**64
NEAR_CLAMP = 2.0**30
NEAR_SLOPE = 2.0**-8
NEAR_PAD = 2.0


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    return a / torch.full_like(a, b)


def transform_corners(corner_world: torch.Tensor, view_proj: torch.Tensor) -> torch.Tensor:
    """(F, 3, 3) world corners -> (F, 3, 4) clip, world_h @ view_proj.T.

    Written out as the sum XLA's CPU dot computes for this shape,
    (x*m0 + y*m1) + (z*m2 + 1*m3) with 1*m3 == m3, so the CPU tests match
    the reference bit for bit; a cuBLAS matmul would fuse multiply-adds."""
    f = corner_world.shape[0]
    w = corner_world.reshape(f * 3, 3)
    m = view_proj
    x, y, z = w[:, 0:1], w[:, 1:2], w[:, 2:3]
    clip = (x * m[:, 0] + y * m[:, 1]) + (z * m[:, 2] + m[:, 3])
    return clip.reshape(f, 3, 4)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cross(a, b) with each component rounded once as fma(p, q, -(r*s)):
    the form XLA's CPU backend compiles jnp.cross to (LLVM contracts the
    multiply-subtract), so setup rows match the reference bit for bit.
    p*q is exact in float64, and so is the difference wherever the two
    products cancel; elsewhere the float64 rounding sits 29 bits below
    the float32 one."""
    a64, b64 = a.double(), b.double()

    def comp(i, j):
        return (a64[:, i] * b64[:, j] - (a[:, j] * b[:, i]).double()).float()

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def triangle_setup(clip: torch.Tensor, faces, n_faces: int, width: int, height: int) -> dict:
    """Per-triangle rasterization setup (geometry.py triangle_setup).

    clip: (F, 3, 4) corner clip coords (faces=None), or (V, 4) with faces
    (F, 3) vertex indices. Returns setup (F, 24) f32, valid (F,) bool,
    aabb (F, 4) f32 and det (F,) f32."""
    c = clip if faces is None else clip[faces.long()]
    dev = c.device
    nf = c.shape[0]
    w = c[..., 3]
    vx = (c[..., 0] + w) * (width * 0.5)
    vy = (w - c[..., 1]) * (height * 0.5)

    eps = 1e-20
    w_ok = w > eps
    one = torch.ones_like(w)
    sx = torch.where(w_ok, vx / torch.where(w_ok, w, one), torch.zeros_like(w))
    sy = torch.where(w_ok, vy / torch.where(w_ok, w, one), torch.zeros_like(w))
    first_ok = torch.argmax(w_ok.to(torch.int8), dim=-1)  # first True, 0 if none
    ax = torch.round(torch.gather(sx, 1, first_ok[:, None])[:, 0])
    ay = torch.round(torch.gather(sy, 1, first_ok[:, None])[:, 0])
    any_ok = w_ok.any(dim=-1)
    zero = torch.zeros_like(ax)
    ax = torch.where(any_ok, torch.clamp(ax, -4 * width, 5 * width), zero)
    ay = torch.where(any_ok, torch.clamp(ay, -4 * height, 5 * height), zero)

    v = torch.stack([vx - ax[:, None] * w, vy - ay[:, None] * w, w], dim=-1)
    e0 = _cross(v[:, 1], v[:, 2])
    e1 = _cross(v[:, 2], v[:, 0])
    e2 = _cross(v[:, 0], v[:, 1])
    p = e0 * v[:, 0]
    det = (p[:, 0] + p[:, 1]) + p[:, 2]

    face_ids = torch.arange(nf, dtype=torch.int32, device=dev)
    in_range = face_ids < n_faces
    finite = torch.isfinite(c.reshape(nf, -1)).all(dim=-1)
    front = det < 0.0
    valid = in_range & finite & front & any_ok

    any_behind = ~w_ok.all(dim=-1)
    big = torch.full_like(sx, 1e9)
    minx = torch.where(any_behind, zero, torch.where(w_ok, sx, big).amin(dim=-1))
    miny = torch.where(any_behind, zero, torch.where(w_ok, sy, big).amin(dim=-1))
    maxx = torch.where(any_behind, torch.full_like(zero, float(width)),
                       torch.where(w_ok, sx, -big).amax(dim=-1))
    maxy = torch.where(any_behind, torch.full_like(zero, float(height)),
                       torch.where(w_ok, sy, -big).amax(dim=-1))
    aabb = torch.stack([minx, miny, maxx, maxy], dim=-1)

    on_screen = (maxx >= 0.0) & (maxy >= 0.0) & (minx < width) & (miny < height)
    valid = valid & on_screen

    setup = torch.cat(
        [
            e0,
            e1,
            e2,
            c[..., 2],
            w,
            face_ids.to(torch.float32)[:, None],
            ax[:, None],
            ay[:, None],
            miny[:, None],
            maxy[:, None],
            torch.zeros((nf, SETUP_WIDTH - 20), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    ).to(torch.float32)
    return {"setup": setup.contiguous(), "valid": valid, "aabb": aabb, "det": det}


def _setup_kernel(corner_world, view_proj, n_faces: int, width: int, height: int):
    """setup_faces on the card (csrc/setup.cu tr_setup): one launch writes
    the clip corners and triangle_setup's four outputs; view_proj is read
    through its pointer, so a CUDA graph's replay reads the matrix its
    static input holds then."""
    f = corner_world.shape[0]
    _k.check(corner_world, "corner_world", torch.float32, (f, 3, 3))
    _k.check(view_proj, "view_proj", torch.float32, (4, 4))
    if corner_world.data_ptr() % 16:
        raise ValueError("corner_world: must start on the 16-byte grid")
    dev = corner_world.device
    clip = torch.empty((f, 3, 4), dtype=torch.float32, device=dev)
    out = {
        "setup": torch.empty((f, SETUP_WIDTH), dtype=torch.float32, device=dev),
        "valid": torch.empty((f,), dtype=torch.bool, device=dev),
        "aabb": torch.empty((f, 4), dtype=torch.float32, device=dev),
        "det": torch.empty((f,), dtype=torch.float32, device=dev),
    }
    _build.call("tr_setup", corner_world, view_proj, f, int(n_faces), int(width), int(height), clip, out["setup"],
                out["valid"], out["aabb"], out["det"])
    _k.LAUNCHES["setup"] += 1
    return clip, out


def setup_faces(corner_world: torch.Tensor, view_proj: torch.Tensor, n_faces: int, width: int, height: int):
    """transform_corners, then triangle_setup on the corners (faces=None):
    (F, 3, 3) world corners and the (4, 4) view_proj -> (clip (F, 3, 4),
    {setup, valid, aabb, det}), the frame's geometry stage. CUDA tensors
    take csrc/setup.cu in one launch (_setup_kernel), the same bits; CPU
    tensors and plain_kernels() the two torch functions."""
    if _k.use_kernel(corner_world, view_proj):
        return _setup_kernel(corner_world, view_proj, n_faces, width, height)
    clip = transform_corners(corner_world, view_proj)
    return clip, triangle_setup(clip, None, n_faces, width, height)


def _tile_ranges(aabb, valid, tiles_x, tiles_y, tile_w, tile_h, ty_base=0):
    """Clamped per-face tile ranges + tile-grid intersection culling
    (geometry.py _tile_ranges)."""
    btx0 = torch.floor(_div(aabb[:, 0], tile_w))
    bty0 = torch.floor(_div(aabb[:, 1], tile_h)) - ty_base
    btx1 = torch.floor(_div(aabb[:, 2], tile_w))
    bty1 = torch.floor(_div(aabb[:, 3], tile_h)) - ty_base
    intersects = (btx1 >= 0.0) & (bty1 >= 0.0) & (btx0 < tiles_x) & (bty0 < tiles_y)
    tx0 = torch.clamp(btx0, 0, tiles_x - 1).to(torch.int32)
    ty0 = torch.clamp(bty0, 0, tiles_y - 1).to(torch.int32)
    tx1 = torch.clamp(btx1, 0, tiles_x - 1).to(torch.int32)
    ty1 = torch.clamp(bty1, 0, tiles_y - 1).to(torch.int32)
    return tx0, ty0, tx1, ty1, valid & intersects


def near_boxes(aabb, valid, clip, width: int, height: int):
    """The boxes the binners range faces by, with faces cut by the eye plane
    tightened (csrc/bin.cu near_box; constants above). A valid face whose
    setup box is the whole screen (0, 0, width, height) and which has a
    corner at w <= EYE_EPS is cut: it is ranged by the box of its part on the
    near side of w = NEAR_K * z (the corners kept and the crossings of its
    edges, each projected as triangle_setup projects a corner), and names no
    tile where that part is empty. clip: the (F, 3, 4) clip-space corners of
    the setup. Returns (aabb (F, 4), valid (F,), cut (F,) bool). Elementwise
    over every face, so that nothing is read back."""
    x, y, z, w = clip.unbind(-1)
    full = (aabb[:, 0] == 0.0) & (aabb[:, 1] == 0.0) & (aabb[:, 2] == float(width)) & (aabb[:, 3] == float(height))
    cut = valid & full & ~(w > EYE_EPS).all(dim=-1)
    zmin = z.amin(dim=-1)
    tame = (clip.abs() <= NEAR_MAX).flatten(1).all(dim=-1) & (zmin > 0.0)
    tame = tame & (w.abs().amax(dim=-1) <= zmin * NEAR_RATIO)
    d = w - z * NEAR_K
    keep = d >= 0.0

    def nxt(v):  # corner i + 1 beside corner i: edge i runs from one to the other
        return torch.roll(v, -1, dims=1)

    cross = keep != nxt(keep)
    t = d / torch.where(cross, d - nxt(d), torch.ones_like(d))

    def on_edge(v):
        return v + t * (nxt(v) - v)

    px, py, pw = (torch.cat([v, on_edge(v)], dim=1) for v in (x, y, w))
    point = torch.cat([keep, cross], dim=1)
    bad = (point & ~(pw > 0.0)).any(dim=-1)
    pw_safe = torch.where(point & (pw > 0.0), pw, torch.ones_like(pw))
    sx = torch.clamp((px + pw) * (width * 0.5) / pw_safe, -NEAR_CLAMP, NEAR_CLAMP)
    sy = torch.clamp((pw - py) * (height * 0.5) / pw_safe, -NEAR_CLAMP, NEAR_CLAMP)
    inf = torch.full_like(sx, float("inf"))
    lo = torch.stack([torch.where(point, s, inf).amin(dim=-1) for s in (sx, sy)], dim=-1)
    hi = torch.stack([torch.where(point, s, -inf).amax(dim=-1) for s in (sx, sy)], dim=-1)
    box = torch.cat([lo - lo.abs() * NEAR_SLOPE - NEAR_PAD, hi + hi.abs() * NEAR_SLOPE + NEAR_PAD], dim=-1)
    tight = cut & tame & ~bad
    has = point.any(dim=-1)
    return torch.where((tight & has)[:, None], box, aabb), valid & ~(tight & ~has), cut


def _check_fields(f: int, t: int) -> None:
    if f > 1 << FACE_BITS or t * YB >= 1 << TILE_KEY_BITS:
        raise ValueError(f"binning: {f} faces and {t} tiles exceed the sort-key fields (at most 2^{FACE_BITS} "
                         f"faces, tiles * {YB} under 2^{TILE_KEY_BITS})")


def _bin_kernel(aabb, valid, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face, huge_budget, ty_base,
                pair_capacity=None, near=None) -> dict:
    """Both binners on the card (csrc/bin.cu tr_bin): bin_pairs'
    outputs (pair_capacity None: the pair slots of the plain version, each
    tile's faces by y-bucket, then face) or bin_triangles' (each tile's faces
    by face, pair_faces of pair_capacity entries, 0 past the binned pairs),
    with near-plane boxes where ``near`` is given (near_boxes). Only the live
    prefix [0, offsets[-1]) of pair_faces and pair_tiles is written; scratch
    and outputs are allocated here and nothing is read back."""
    f, t = aabb.shape[0], tiles_x * tiles_y
    _check_fields(f, t)
    _k.check(aabb, "aabb", torch.float32, (f, 4))
    _k.check(valid, "valid", torch.bool, (f,))
    clip, width, height = (None, 0, 0) if near is None else near
    if clip is not None:
        _k.check(clip, "clip", torch.float32, (f, 3, 4))
    by_y = pair_capacity is None
    args = (f, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face, huge_budget, int(ty_base), int(by_y))
    n_scratch = _build.library().tr_bin_scratch(*args)
    if n_scratch < 0:
        raise ValueError(f"binning kernel: refuses {args} (tiles_x, tiles_y, tile_w, tile_h at least 1, "
                         "tiles_per_face at least 0, fewer than 2^31 pair slots)")
    dev = aabb.device
    slots = tiles_per_face * f + max(0, min(huge_budget, f)) * t
    scratch = torch.empty((n_scratch,), dtype=torch.int32, device=dev)
    pair_faces = torch.empty((slots if by_y else pair_capacity,), dtype=torch.int32, device=dev)
    pair_tiles = torch.empty((slots,), dtype=torch.int32, device=dev) if by_y else None
    offsets = torch.empty((t + 1,), dtype=torch.int32, device=dev)
    counts = torch.empty((t,), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    outputs = (pair_faces.numel(), pair_faces, pair_tiles, offsets, counts, overflow)
    out = {"pair_faces": pair_faces, "offsets": offsets, "counts": counts, "overflow": overflow}
    faces = None if near is None else torch.empty((2,), dtype=torch.int32, device=dev)
    _build.call("tr_bin", aabb, valid, clip, int(width), int(height), *args, *outputs, faces, scratch, scratch.numel())
    if faces is not None:
        out.update(cut_faces=faces[0], huge_faces=faces[1])
    _k.LAUNCHES["bin"] += 1
    return dict(out, pair_tiles=pair_tiles) if by_y else out


def _expand_pairs(aabb, valid, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face, huge_budget, ty_base, ybucket,
                  cut=None):
    """The (tile, face) pairs both binners sort: the j-th overlapped tile of
    every small face, every tile of the first huge_budget huge faces in
    draw order. Returns (keys (N,) i64 sorted, tile * YB + ybucket[face]
    << FACE_BITS | face, with tile T for slots that hold no pair; the
    dropped pair count of the huge faces beyond the budget, 0-dim; where
    ``cut`` (near_boxes) is given, (2,) i32: the cut faces that name a
    tile and the huge faces, else None)."""
    f = aabb.shape[0]
    t = tiles_x * tiles_y
    _check_fields(f, t)
    dev = aabb.device
    tx0, ty0, tx1, ty1, valid = _tile_ranges(aabb, valid, tiles_x, tiles_y, tile_w, tile_h, ty_base)
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    span = torch.where(valid, span_x * span_y, torch.zeros_like(span_x))
    face_ids = torch.arange(f, dtype=torch.int32, device=dev)
    huge = valid & (span > tiles_per_face)
    sentinel = t * YB

    # Rounds: (TPF, F) j-th tile of each small face.
    j = torch.arange(tiles_per_face, dtype=torch.int32, device=dev)[:, None]
    sx = torch.clamp(span_x, min=1)[None, :]
    jx = j % sx
    jy = j // sx
    tile_j = (ty0[None, :] + jy) * tiles_x + (tx0[None, :] + jx)
    ok = (valid & ~huge)[None, :] & (j < span[None, :])
    # Tile keys in int64: tiles * YB may pass 2^31.
    keys_small = torch.where(ok, tile_j.long() * YB + ybucket[None, :], sentinel).reshape(-1)
    vals_small = face_ids[None, :].expand(tiles_per_face, f).reshape(-1)

    # Huge faces: the first huge_budget in draw order. Weights f - id are
    # distinct, so topk's set equals lax.top_k's; the zero-weight filler
    # entries are masked below either way.
    hb = min(huge_budget, f)
    hw = torch.where(huge, f - face_ids, torch.zeros_like(face_ids))
    hidx = torch.topk(hw, hb).indices.to(torch.int32)
    hl = hidx.long()
    h_ok_face = huge[hl]
    jh = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    hsx = torch.clamp(span_x[hl], min=1)[:, None]
    hx = jh % hsx
    hy = jh // hsx
    h_tile = (ty0[hl][:, None] + hy) * tiles_x + tx0[hl][:, None] + hx
    h_ok = h_ok_face[:, None] & (jh < span[hl][:, None])
    keys_huge = torch.where(h_ok, h_tile.long() * YB + ybucket[hl][:, None], sentinel).reshape(-1)
    vals_huge = hidx[:, None].expand(hb, t).reshape(-1)

    keys = torch.cat([keys_small, keys_huge])
    vals = torch.cat([vals_small, vals_huge]).to(torch.int64)
    packed, _ = torch.sort((keys << FACE_BITS) | vals, stable=True)
    dropped = torch.where(huge, span, torch.zeros_like(span)).sum() - torch.where(
        h_ok_face, span[hl], torch.zeros_like(hidx)
    ).sum()
    faces = None if cut is None else torch.stack([(valid & cut).sum(), huge.sum()]).to(torch.int32)
    return packed, dropped.to(torch.int32), faces


def _with_faces(out: dict, faces) -> dict:
    """The binners' outputs, with cut_faces and huge_faces where
    _expand_pairs counted them (near= given)."""
    return out if faces is None else dict(out, cut_faces=faces[0], huge_faces=faces[1])


def bin_pairs(
    aabb,
    valid,
    tiles_x,
    tiles_y,
    tile_w,
    tile_h,
    tiles_per_face: int = TILES_PER_FACE,
    huge_budget: int = HUGE_BUDGET,
    ty_base=0,
    near=None,
) -> dict:
    """Pair-expansion binning (geometry.py bin_pairs): the j-th overlapped
    tile of every small face, a dense round for the first huge_budget
    huge faces (excess huge faces dropped and counted), one sort by
    (tile, 8-row y-bucket, face), then searchsorted.

    The reference's 2-key lax.sort becomes one stable sort of a single
    int64 key (tile*YB + ybucket) << FACE_BITS | face. Returns pair_faces (P,)
    i32, pair_tiles (P,) i32, offsets (T+1,) i32, counts (T,) i32 and
    overflow (the dropped pair count, 0-dim i32). CUDA tensors take
    csrc/bin.cu (_bin_kernel), which writes only the live prefix of the P
    slots.

    near: None, or (clip (F, 3, 4), width, height) of the setup: the faces
    cut by the eye plane are then ranged by their near-plane boxes
    (near_boxes) in place of the whole screen, and the outputs add
    cut_faces and huge_faces (0-dim i32: the cut faces that name a tile,
    the faces of more than tiles_per_face tiles). Frames stay the same
    bits, since the raster covers nothing of such a face outside that box.
    The reference has no such input."""
    if _k.use_kernel(aabb, valid):
        return _bin_kernel(aabb, valid, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face, huge_budget, ty_base,
                           near=near)
    t = tiles_x * tiles_y
    cut = None
    if near is not None:
        aabb, valid, cut = near_boxes(aabb, valid, *near)
    ybucket = torch.clamp(torch.floor(aabb[:, 1] * (1.0 / 8.0)), 0, YB - 1).to(torch.int32)
    packed, dropped, faces = _expand_pairs(aabb, valid, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face,
                                           huge_budget, ty_base, ybucket, cut)
    pair_keys = packed >> FACE_BITS
    pair_faces = (packed & ((1 << FACE_BITS) - 1)).to(torch.int32)
    pair_tiles = (pair_keys // YB).to(torch.int32)

    bounds = torch.arange(t + 1, dtype=torch.int64, device=aabb.device) * YB
    offsets = torch.searchsorted(pair_keys, bounds).to(torch.int32)
    counts = offsets[1:] - offsets[:-1]
    out = {
        "pair_faces": pair_faces,
        "pair_tiles": pair_tiles,
        "offsets": offsets,
        "counts": counts,
        "overflow": dropped,
    }
    return _with_faces(out, faces)


def bin_triangles(
    aabb,
    valid,
    tiles_x,
    tiles_y,
    tile_w,
    tile_h,
    pair_capacity: int,
    tiles_per_face: int = TILES_PER_FACE,
    huge_budget: int = HUGE_BUDGET,
    ty_base=0,
    face_chunk: int = 8192,
    near=None,
) -> dict:
    """Tiled binning into a compact pair buffer of pair_capacity slots
    (geometry.py bin_triangles). Its contract, unlike bin_pairs': a tile's
    faces are in draw order (no y-bucket); pair_faces has exactly
    pair_capacity slots, those past the binned pairs 0; offsets and counts
    are clamped to the capacity; overflow is the pairs of the huge faces
    beyond huge_budget plus the pairs past the capacity.

    The reference ranks faces per tile with a chunked scan over dense
    (T, face_chunk) overlap masks, which dodges the TPU's sort floor.
    Here the pairs are bin_pairs' and sort once by tile << FACE_BITS | face:
    a pair's place in the sorted list is its offsets[tile] + draw-order
    rank, where the reference scatters it. face_chunk only bounds the
    reference's memory and is accepted for its signature. Returns
    pair_faces (pair_capacity,) i32, offsets (T+1,) i32, counts (T,) i32
    and overflow (0-dim i32); nothing is read back to the host. near (and
    cut_faces, huge_faces) as bin_pairs'. CUDA tensors take csrc/bin.cu
    (_bin_kernel) with one y-bucket."""
    del face_chunk
    if _k.use_kernel(aabb, valid):
        return _bin_kernel(aabb, valid, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face, huge_budget, ty_base,
                           pair_capacity, near)
    t = tiles_x * tiles_y
    dev = aabb.device
    cut = None
    if near is not None:
        aabb, valid, cut = near_boxes(aabb, valid, *near)
    ybucket = torch.zeros(aabb.shape[0], dtype=torch.int32, device=dev)
    packed, dropped, faces = _expand_pairs(aabb, valid, tiles_x, tiles_y, tile_w, tile_h, tiles_per_face,
                                           huge_budget, ty_base, ybucket, cut)
    pair_tiles = (packed >> FACE_BITS) // YB
    offsets = torch.searchsorted(pair_tiles, torch.arange(t + 1, dtype=torch.int64, device=dev)).to(torch.int32)
    n = offsets[-1]
    keep = min(packed.shape[0], pair_capacity)
    slots = torch.arange(keep, device=dev)
    pair_faces = torch.zeros(pair_capacity, dtype=torch.int32, device=dev)
    pair_faces[:keep] = torch.where(slots < n, packed[:keep] & ((1 << FACE_BITS) - 1), 0).to(torch.int32)
    clamped = torch.clamp(offsets, max=pair_capacity)
    out = {
        "pair_faces": pair_faces,
        "offsets": clamped,
        "counts": clamped[1:] - clamped[:-1],
        "overflow": dropped + torch.clamp(n - pair_capacity, min=0),
    }
    return _with_faces(out, faces)
