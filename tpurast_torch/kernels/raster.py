"""Visibility raster: depth and winning face id per pixel.

Replaces the Pallas kernel tpurast/kernels/raster.py::_raster_kernel
(launched by rasterize_tiles). The CUDA kernel is csrc/raster.cu; the
plain torch version below computes the same bits and is what CPU tensors
take.

Semantics (raster.py:79-223): anchored homogeneous edge functions at
pixel centers, the top-left fill rule, the all-positive region only for
triangles crossing w=0, w(p) > 0 and z in [0, 1], reversed-Z
GreaterEqual against clear_depth. The merge rule is order-free: the
largest depth wins and, on equal depth, the largest face id (the later
draw). The reference documents the same rule; its implementation keeps
the later *sub-block in bin order* on ties across sub-blocks, which
differs only for exact depth ties between faces in different 8-row
y-buckets.

The port has no segment schedule: every pair of a tile's range
[offsets[t], offsets[t+1]) of the binned pair list is evaluated, so no
segment is ever dropped. A pair covers only the pixels of its tile in its
face's pixel rectangle: rows [floor(ymin) - 1, floor(ymax) + 1] and
columns [floor(xmin) - 1, floor(xmax) + 1] of the face's screen AABB
(the reference's one-pixel widening of its 8-row groups, raster.py:140-149,
taken per row and applied to x too). Both versions apply it, the kernel
by visiting only those pixels, the plain version as a mask.

tile_row_offset renders a slab (renderer.render_frame, parallel.py): tile
row r of the output is tile row r + tile_row_offset of the frame. Pixel
coordinates, and so coverage, depth and the rectangles' clamp, are the
frame's; the output rows are the slab's (raster.py:353-364).
"""

from __future__ import annotations

import torch

from tpurast_torch import kernels as _k
from tpurast_torch.kernels import _build
from tpurast_torch.kernels import geometry as _g

# (pair, pixel) evaluations per step of the plain version: 2048 pairs of a
# 4096-px tile, fewer pairs of a larger tile.
PLAIN_STEP_EVALS = 2048 * 4096
# Pixels of a raster work unit's key buffer in a block's shared memory, and
# the sub-rectangle a taller tile is cut into (csrc/raster.cu kMaxTilePx,
# kSubW x kSubH).
MAX_UNIT_PX = 4096
SUB_W, SUB_H = 128, 32
# Pairs per raster work unit (csrc/raster.cu kChunk).
UNIT_PAIRS = 128


def _edge_covered(e, a, b):
    """Interior-negative coverage with the top-left fill rule
    (raster.py _edge_covered)."""
    on_edge_ok = (a < 0.0) | ((a == 0.0) & (b < 0.0))
    return (e < 0.0) | ((e == 0.0) & on_edge_ok)


def _fragments(rows, px, py):
    """Coverage and depth of faces with setup rows (N, 24) at pixel
    centers px, py (N, P), raster.py:151-191."""

    def f(i):
        return rows[:, i : i + 1]

    pxr = px - f(_g.FIELD_ANCHOR_X)
    pyr = py - f(_g.FIELD_ANCHOR_Y)
    e0 = pxr * f(0) + pyr * f(1) + f(2)
    e1 = pxr * f(3) + pyr * f(4) + f(5)
    e2 = pxr * f(6) + pyr * f(7) + f(8)
    crossing = (f(12) <= 0.0) | (f(13) <= 0.0) | (f(14) <= 0.0)
    cov_n = _edge_covered(e0, f(0), f(1)) & _edge_covered(e1, f(3), f(4)) & _edge_covered(e2, f(6), f(7))
    cov_p = (
        crossing
        & _edge_covered(-e0, -f(0), -f(1))
        & _edge_covered(-e1, -f(3), -f(4))
        & _edge_covered(-e2, -f(6), -f(7))
    )
    esum = e0 + e1 + e2
    ez = e0 * f(9) + e1 * f(10) + e2 * f(11)
    ew = e0 * f(12) + e1 * f(13) + e2 * f(14)
    w_front = (ew * esum) > 0.0
    z = ez / torch.where(ew == 0.0, torch.full_like(ew, 1e-30), ew)
    z_ok = (z >= 0.0) & (z <= 1.0)
    return (cov_n | cov_p) & w_front & z_ok, z


def pixel_rects(aabb):
    """(F, 4) screen AABBs -> (F, 4) f32 inclusive pixel bounds x0, y0, x1,
    y1: floor(min) - 1 and floor(max) + 1, as whole numbers in f32."""
    lo = torch.floor(aabb[:, 0:2]) - 1.0
    hi = torch.floor(aabb[:, 2:4]) + 1.0
    return torch.cat([lo, hi], dim=1)


def rasterize_tiles_plain(setup, aabb, pair_faces, offsets, *, tile_h, tile_w, tiles_x, tiles_y, clear_depth=0.0,
                          tile_row_offset: int = 0):
    """Plain torch version of the raster kernel, chunked over pairs.

    Each (tile, face) pair is evaluated at every pixel of its tile and
    masked to its face's pixel rectangle (pixel_rects); the winners merge
    with one scatter-amax over an int64 key (depth bits << 32 | face id +
    1): covered depths lie in [0, 1], so their f32 bit patterns order like
    their values, and the low word breaks ties to the larger face id."""
    if clear_depth < 0.0:
        raise ValueError("clear_depth must be >= 0 (reversed-Z)")
    dev = setup.device
    hp, wp = tiles_y * tile_h, tiles_x * tile_w
    n_pairs = int(offsets[-1])
    rects = pixel_rects(aabb)
    clear_bits = int(torch.tensor(float(clear_depth) + 0.0, dtype=torch.float32).view(torch.int32))
    best = torch.full((hp * wp,), clear_bits << 32, dtype=torch.int64, device=dev)

    lin = torch.arange(tile_h * tile_w, device=dev)
    loc_x = (lin % tile_w)[None, :]
    loc_y = (lin // tile_w)[None, :]
    pair_tile = torch.searchsorted(offsets[1:].long(), torch.arange(n_pairs, device=dev), right=True)
    step = max(1, PLAIN_STEP_EVALS // (tile_h * tile_w))
    for s in range(0, n_pairs, step):
        e = min(s + step, n_pairs)
        tiles = pair_tile[s:e][:, None]
        faces = pair_faces[s:e].long()
        gx = (tiles % tiles_x) * tile_w + loc_x  # (N, P) pixel x
        gy = (tiles // tiles_x) * tile_h + loc_y  # output row
        fx, fy = gx.to(torch.float32), (gy + tile_row_offset * tile_h).to(torch.float32)  # frame row
        covered, z = _fragments(setup[faces], fx + 0.5, fy + 0.5)
        r = rects[faces]
        covered &= (fx >= r[:, 0:1]) & (fy >= r[:, 1:2]) & (fx <= r[:, 2:3]) & (fy <= r[:, 3:4])
        zbits = (z + 0.0).view(torch.int32).to(torch.int64)  # -0.0 -> +0.0
        key = torch.where(covered, (zbits << 32) | (faces[:, None] + 1), torch.full_like(zbits, -1))
        best.scatter_reduce_(0, (gy * wp + gx).reshape(-1), key.reshape(-1), "amax")
    depth = (best >> 32).to(torch.int32).view(torch.float32)
    fid = ((best & 0xFFFFFFFF) - 1).to(torch.float32)
    return torch.stack([depth, fid]).reshape(2, hp, wp)


def tile_subs(tile_h: int, tile_w: int) -> tuple[int, int, int, int]:
    """(w, h, nx, ny): the sub-rectangles of at most MAX_UNIT_PX pixels that
    the raster kernel cuts a tile into (csrc/raster.cu tile_subs), nx x ny
    of w x h pixels, the last column and row of them narrower or shorter.
    A tile of at most MAX_UNIT_PX pixels is one; a larger tile is cut into
    the tile's rows over as many whole SUB_W-column strips as fit, or
    SUB_W x SUB_H where not even one fits (tiles taller than SUB_H rows)."""
    if tile_h * tile_w <= MAX_UNIT_PX:
        w, h = tile_w, tile_h
    else:
        w = min(tile_w, max(SUB_W, MAX_UNIT_PX // tile_h // SUB_W * SUB_W))
        h = min(tile_h, MAX_UNIT_PX // w)
    return w, h, -(-tile_w // w), -(-tile_h // h)


def kernel_buffers(tile_h: int, tile_w: int, tiles_x: int, tiles_y: int, slots: int,
                   device) -> tuple[torch.Tensor, ...]:
    """The raster kernel's scratch and output for tiles_x x tiles_y tiles
    of tile_h x tile_w and a pair list of slots entries: the frame's 64-bit
    key buffer, the unit table (each tile's first unit, the unit count and
    counter, each unit's tile; n_subs units per chunk of UNIT_PAIRS pairs),
    sized by the pair list's length so that the host never reads a count,
    and the (2, Hp, Wp) output."""
    hp, wp, n_tiles = tiles_y * tile_h, tiles_x * tile_w, tiles_x * tiles_y
    _, _, nx, ny = tile_subs(tile_h, tile_w)
    keys = torch.empty((hp * wp,), dtype=torch.int64, device=device)
    work = torch.empty((n_tiles + 2 + nx * ny * (n_tiles + -(-slots // UNIT_PAIRS)),), dtype=torch.int32,
                       device=device)
    out = torch.empty((2, hp, wp), dtype=torch.float32, device=device)
    return keys, work, out


def rasterize_tiles(setup, aabb, pair_faces, offsets, *, tile_h, tile_w, tiles_x, tiles_y, clear_depth=0.0,
                    tile_row_offset: int = 0):
    """Visibility raster over all tiles (raster.py rasterize_tiles).

    setup (F, 24) f32 and aabb (F, 4) f32 from triangle_setup;
    pair_faces (P,) i32 and offsets (T+1,) i32 from bin_pairs or
    bin_triangles. Returns (2, Hp, Wp) f32: plane 0 depth, plane 1 face id
    (-1 = none), Hp = tiles_y*tile_h, Wp = tiles_x*tile_w; tile_row_offset
    (a Python int) is the first frame tile row of a slab. CPU tensors run
    the plain version; CUDA tensors launch csrc/raster.cu."""
    if not _k.use_kernel(setup, aabb, pair_faces, offsets):
        return rasterize_tiles_plain(
            setup, aabb, pair_faces, offsets, tile_h=tile_h, tile_w=tile_w,
            tiles_x=tiles_x, tiles_y=tiles_y, clear_depth=clear_depth, tile_row_offset=tile_row_offset,
        )
    _k.check(setup, "setup", torch.float32)
    if setup.dim() != 2 or setup.shape[1] != _g.SETUP_WIDTH:
        raise ValueError(f"setup: expected (F, {_g.SETUP_WIDTH}), got {tuple(setup.shape)}")
    _k.check(aabb, "aabb", torch.float32, (setup.shape[0], 4))
    _k.check(pair_faces, "pair_faces", torch.int32)
    _k.check(offsets, "offsets", torch.int32, (tiles_x * tiles_y + 1,))
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile_h and tile_w must be positive, got {tile_h} x {tile_w}")
    if clear_depth < 0.0:
        raise ValueError("clear_depth must be >= 0 (reversed-Z)")
    slots = pair_faces.numel()
    keys, work, out = kernel_buffers(tile_h, tile_w, tiles_x, tiles_y, slots, setup.device)
    _build.call(
        "tr_raster", setup, aabb, pair_faces, offsets, slots, tiles_x, tiles_y, tile_h, tile_w, tile_row_offset,
        float(clear_depth) + 0.0, keys, work, work.numel(), out,
    )
    _k.LAUNCHES["raster"] += 1
    return out
