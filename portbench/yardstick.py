"""The work a frame's inputs need, and the least time the card could take for it.

Frozen copies of chip_smoke.py's bound arithmetic (bound, raster_bound,
the sample bound of kernel_phases, shade_bound): a kernel's bound is the
larger of its bytes over the card's memory rate and its float32
operations over the float32 peak, each input read once and each output
written once. The counts come from the reference's own frame
(portbench/reference/render.py), never from the program's buffers: the
(tile, face) pairs of its binning, the pixels its raster covers, the
probes its footprints ask for and the distinct texels (window sampler) or
atlas rows (deferred shading) those probes read. So a roofline share is
of the work the frame needs, whatever implements it.
"""

from __future__ import annotations

import json
import pathlib

import torch

PEAKS = json.loads((pathlib.Path(__file__).with_name("peaks.json")).read_text())

# Raster: float32 operations per evaluated (pair, pixel), and the bytes of
# one face it must read (setup fields 0-17 and the AABB).
RASTER_FLOPS_PER_EVAL = 40
RASTER_FACE_BYTES = 18 * 4 + 4 * 4
# Sample: the G-buffer planes it reads, operations per probe.
SAMPLE_PLANES = 21
SAMPLE_FLOPS_PER_PROBE = 100
PAGE_TEXEL_BYTES = 8  # four bfloat16 channels
# Deferred shading: the face row, the atlas row, operations per probe and pixel.
SHADE_ROW_FLOATS = 104
ATLAS_ROW_TEXELS = 13
SHADE_FLOPS_PER_PROBE = 160
SHADE_FLOPS_PER_PIXEL = 80
DEFERRED_FLOPS_PER_PIXEL = 150
ROW_TEXEL_BYTES = {"srgb8": 4, "float16": 8}


def bound_ms(nbytes: float, flops: float) -> float:
    """max(bytes / memory rate, f32 operations / f32 peak), in ms."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / PEAKS["f32_flops_per_s"]) * 1e3


def frame_work(setup, pair_tile, pair_face, fid_flat, pix, g, t, dr) -> dict:
    """The counts of one reference frame that its bounds read, but for
    ``distinct``: the texels (window sampler) or rows (deferred) its live
    probes read, which the sampler marks in ``touched``."""
    hp, wp = t.tiles_y * t.tile_h, t.tiles_x * t.tile_w
    rects = torch.cat([torch.floor(setup["aabb"][:, 0:2]) - 1.0, torch.floor(setup["aabb"][:, 2:4]) + 1.0], dim=1)
    r = rects[pair_face]
    gx0 = ((pair_tile % t.tiles_x) * t.tile_w).to(torch.float32)
    gy0 = ((pair_tile // t.tiles_x) * t.tile_h).to(torch.float32)
    w = torch.minimum(r[:, 2], gx0 + (t.tile_w - 1)) - torch.maximum(r[:, 0], gx0) + 1
    h = torch.minimum(r[:, 3], gy0 + (t.tile_h - 1)) - torch.maximum(r[:, 1], gy0) + 1
    return dict(
        hp=hp, wp=wp, tiles=t.tiles_x * t.tiles_y, pairs=int(pair_face.numel()),
        faces=int(torch.unique(pair_face).numel()),
        evals=int((w.clamp(min=0).double() * h.clamp(min=0).double()).sum()),
        covered=int(pix.numel()), covered_faces=int(torch.unique(fid_flat[pix]).numel()),
        probes=int(g["n_px"].sum()), row_format=dr.fmt,
    )


def raster_bound(s: dict) -> float:
    return bound_ms(s["faces"] * RASTER_FACE_BYTES + s["pairs"] * 4 + (s["tiles"] + 1) * 4 + 2 * s["hp"] * s["wp"] * 4,
                    s["evals"] * RASTER_FLOPS_PER_EVAL)


def sample_bound(s: dict) -> float:
    """The match plane at every pixel, the other planes at the covered
    ones, each tile's class, each distinct page texel once, the four
    framebuffer planes written."""
    px = s["hp"] * s["wp"]
    return bound_ms(px * 4 + (SAMPLE_PLANES - 1) * s["covered"] * 4 + s["tiles"] * 4
                    + s["distinct"] * PAGE_TEXEL_BYTES + 4 * px * 4, s["probes"] * SAMPLE_FLOPS_PER_PROBE)


def deferred_bound(s: dict) -> float:
    """The face id at every pixel, each covered face's row once, each
    distinct atlas row once (and the sRGB decode table), the four
    framebuffer planes written."""
    px = s["hp"] * s["wp"]
    row_bytes = s["distinct"] * ATLAS_ROW_TEXELS * ROW_TEXEL_BYTES[s["row_format"]]
    lut = 256 * 4 if s["row_format"] == "srgb8" else 0
    return bound_ms(px * 4 + s["covered_faces"] * SHADE_ROW_FLOATS * 4 + row_bytes + lut + 4 * px * 4,
                    s["covered"] * (SHADE_FLOPS_PER_PIXEL + DEFERRED_FLOPS_PER_PIXEL)
                    + s["probes"] * SHADE_FLOPS_PER_PROBE)


BOUNDS = {"raster": raster_bound, "sample": sample_bound, "deferred": deferred_bound}
