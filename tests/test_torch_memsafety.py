"""The emulated CUDA kernels under AddressSanitizer and ThreadSanitizer, on
the CPU.

tests/test_torch_csrc.py holds the kernels (csrc/*.cu compiled with g++
against csrc/host_emu.h) to their plain versions by value. A value check
does not see a write past the end of an output into a neighbouring
allocation, a read of memory a kernel does not own that happens to give
the same answer, nor two threads of a block touching one word in an order
no barrier fixes. Here the same sources are compiled with
-fsanitize=address, and apart with -fsanitize=thread, into libraries of
the test's own (under pytest's temporary directory, once per module each),
and the cases run in one subprocess of this file per sanitizer with its
runtime preloaded (ASan: detect_leaks=0:abort_on_error=1, so the first
out-of-bounds access aborts with ASan's report; ThreadSanitizer:
halt_on_error=1, torch single-threaded). Every input and output a kernel
is given is a tensor of exactly its size (a copy where the frame's tensor
is a view into a larger one), so that ASan's redzones sit right past each
end of it; the raster kernel's scratch is sized by the wrapper's own
raster.kernel_buffers. The emulation runs a block's threads as
std::threads meeting at its barriers, so ThreadSanitizer reports what the
card's racecheck looks for in shared memory (a read or write of a word
another thread of the block writes, with no barrier or atomic between),
and warp-synchronous code that leans on lockstep. The ASan shapes:

  * a small orbit scene at 256x128 (on the 32x128 tile grid) and at
    130x49, which leaves a padded tile column of 2 frame columns and a
    padded tile row of 17 frame rows, as 1282x721 does: raster, resolve,
    plan and sample;
  * slabs of the 256x128 frame (a first tile row above 0, held to the
    plain whole frame's rows, and a slab below the frame): raster and
    resolve at the slab's row offset;
  * the plan kernel's tile of 24 windows, and a NaN and an infinity under
    a matched pixel;
  * tiles past 4096 px: raster and plan at 16x1024 on the 256x128 frame
    and at 64x128 on the 130x49 frame (the raster's sub-rectangle units,
    the plan's groups of 4096 px and their scratch planes, exact-size);
  * the shade kernels (csrc/shade.cu) on the 130x49 frame's padded G-buffer
    and face ids: gather on float16 rows, deferred on srgb8 rows with the
    256-entry decode table, a third of the atlas offsets moved to the
    table's end, so that rows past it clamp to its last row;
  * the resolve and deferred kernels on their split face rows (the setup
    rows and the scene's table, each exact-size) in SPLIT_CASES: a slab, a
    scene without pages, face ids on the padded rows and past the last
    row, and the last row of both allocations, whose wide loads end at
    the allocation's last byte;
  * vmem_take at an odd row count, with indices outside the table, and on
    an index array off the 16-byte grid;
  * plane_scale off the 16-byte grid in its three launch geometries
    (tile-grid and row-band blocks on a 3-plane buffer, one-plane);
  * the binning kernels (csrc/bin.cu) on random boxes (more huge faces
    than HUGE_BUDGET, some past the frame's edges): bin_pairs' contract on
    the frame and on a slab, bin_triangles' with half the pairs' room, and
    8,100 tiles, where the tile sort runs as two passes; the scratch from
    tr_bin_scratch, exact-size; and with near-plane boxes (tr_bin given clip) on
    near_faces: faces across the eye plane through the setup, and crafted
    cut faces wholly behind the eye, on the eye plane, with NaN and
    infinite corners, the clip corners an exact-size tensor;
  * the setup kernel (csrc/setup.cu tr_setup) at 1, 255, 257 and 2,051
    faces (no whole block, and a last block of 3 faces whose corners end
    off the 16-byte grid), at 2,051 rows of which the last 300 are padding
    past n_faces, with NaN and infinite corners, and on faces crafted so
    that a rounding decides (setup_inputs' ties): the five outputs against
    transform_corners and triangle_setup, bit for bit;
  * the encode kernel (csrc/encode.cu tr_encode) on ENCODE_CASES: a frame
    on the tile grid with padded rows, a width off the 4-pixel grid, a
    slab's crop, rows off the 16-byte grid and the special values
    (encode_inputs), the planes and the output exact-size, then the output
    as a view inside guard bands of 0xA5 bytes (on and off the 4-byte
    grid) whose margins must stay intact: against encode_srgb_u8_plain
    (assert_encode_equal);
  * the port's Zstandard decoder (tpurast_torch/native/zstd.cpp, built
    into the ASan library beside the kernels) on frames made with the
    zstandard package at levels 3 and 19 and on 600 truncated and
    bit-flipped copies of them, each input and output in an allocation
    of exactly its size, plus an output one byte short.

ThreadSanitizer runs RACE_CASES, each kernel once (the shade kernels too:
a block's threads share the srgb8 decode table; the binning kernels, whose
warps keep counters in shared memory and whose last block reads what the
others wrote, on the frame and on a slab; the setup kernel at every face
count, whose block stages corners and rows in shared memory and reuses the
corners' words for the clip rows; the encode kernel, whose neighbouring
threads store neighbouring bytes). Each case is also held
to its plain version under tests/test_torch_csrc.py's budgets. Planted
faults show that the harness catches them: the raster output one tile row
short must abort with ASan's heap-buffer-overflow, and a small kernel that
reads its neighbour's shared word without a barrier must end with
ThreadSanitizer's data race.

Time on one worker: about 120 s (the two builds side by side, then the
four subprocesses side by side: the ThreadSanitizer cases, the shade and
binning kernels among them, take the longest, the planted ones about 5 s
each; the encode cases under a second each: 158 s for the whole file with
them).

Run the cases by hand: python tests/test_torch_memsafety.py LIB OUT.json
CASE... with LD_PRELOAD=$(g++ -print-file-name=libasan.so) (or libtsan.so
and OMP_NUM_THREADS=1), LIB built as ``sanitized_library`` builds it.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tpurast_torch.config import RendererConfig  # noqa: E402
from tpurast_torch.device.scene import build_orbit_scene, orbit_track  # noqa: E402
from tpurast_torch.device.textures import texels_tensor  # noqa: E402
from tpurast_torch.kernels import _build, geometry, present, probes, raster, resolve, sampler, shade  # noqa: E402
from tpurast_torch.renderer import Renderer  # noqa: E402

# Per sanitizer: the g++ flag, the runtime to preload and its options.
# halt_on_error makes ThreadSanitizer's first race end the process with
# exitcode; torch runs single-threaded under it, since the OpenMP runtime
# is not instrumented and its barriers would read as races.
SANITIZERS = {
    "address": dict(flags=["-fsanitize=address", "-fno-omit-frame-pointer"], runtime="libasan.so",
                    env=dict(ASAN_OPTIONS="detect_leaks=0:abort_on_error=1", OMP_NUM_THREADS="2")),
    "thread": dict(flags=["-fsanitize=thread"], runtime="libtsan.so",
                   env=dict(TSAN_OPTIONS="halt_on_error=1:exitcode=66:report_signal_unsafe=0", OMP_NUM_THREADS="1")),
}
# A small orbit scene (3,104 faces; at 256x128 about 3,000 pairs, the
# densest tile split into a few dozen raster work units) and its sizes.
SCENE = dict(floor_quads=32, spheres=2, rings=12, segments=12, tex_size=64, n_textures=2)
SIZES = {"grid": (256, 128), "off_grid": (130, 49)}
CAMERA = 2  # of orbit_track(8): at 130x49 faces reach into the padded tile column and row
SLABS = {"slab_middle": (1, 2), "slab_below_the_frame": (4, 2)}  # (first tile row, tile rows) of the 4-row frame
# Tile shapes past the kernels' 4096-px units, at a size: the raster
# kernel's sub-rectangle units (16x1024: 4 of 16x256; 64x128: 2 of 32x128)
# and the plan kernel's groups of 4096 px with their scratch planes.
LARGE_TILES = (("16x1024", "grid"), ("64x128", "off_grid"))
# The setup kernel's cases (setup_inputs): (rows, rows past n_faces, non-finite corners, rounding ties).
SETUP_CASES = {"1_face": (1, 0, False, False), "255_faces": (255, 0, False, False),
               "257_faces": (257, 0, False, False), "2051_faces": (2051, 0, False, False),
               "2051_padded_non_finite": (2051, 300, True, False), "257_rounding_ties": (257, 0, False, True)}
# The encode kernel's cases (encode_inputs): (Hp, Wp, width, height, the planes' offset in floats past the
# 16-byte grid). A frame on the 128-px tile grid with padded rows (16-byte loads, 4-byte stores); a width
# off the 4-pixel grid (a byte a pixel); a slab's crop, fewer rows than its planes; rows off the 16-byte grid
# (a 4-byte load a pixel); the special values (encode_specials) in every plane.
ENCODE_CASES = {"frame_grid": (136, 256, 256, 130, 0), "odd_width": (64, 256, 201, 64, 0),
                "slab_crop": (96, 384, 384, 37, 0), "off_grid_rows": (33, 130, 127, 31, 1),
                "specials": (24, 128, 128, 24, 0)}
# The resolve and deferred kernels on their split face rows (split_rows):
# a slab (the frame's rows from 32 down, at y_offset 32); the scene's
# tables without its page origins (the resolve table's page bases zero);
# face ids on the padded rows past n_faces and past the last row (those
# read no row: the pixel is uncovered); the last row of both allocations.
SPLIT_CASES = ("slab", "no_pages", "padded_faces", "last_row")

CASES = (
    [f"{k}_{s}" for s in SIZES for k in ("raster", "resolve", "plan", "sample")]
    + [f"{k}_{s}" for s in SLABS for k in ("raster", "resolve")]
    + ["plan_24_windows", "plan_nan_under_a_matched_pixel", "plan_inf_under_a_matched_pixel"]
    + ["vmem_take_odd_rows", "vmem_take_outside_the_table", "vmem_take_unaligned_idx"]
    + ["plane_scale_tile_grid", "plane_scale_one_plane", "plane_scale_row_band"]
    + ["zstd_corrupt_and_truncated_frames"]
    + ["shade_gather_off_grid", "shade_deferred_off_grid"]
    + [f"split_rows_{k}" for k in SPLIT_CASES]
    + [f"{k}_{t}_{s}" for t, s in LARGE_TILES for k in ("raster", "plan")]
    + ["bin_random_faces", "bin_random_faces_slab", "bin_scan_truncated", "bin_two_tile_passes"]
    + ["bin_near_faces", "bin_near_faces_scan"]
    + [f"setup_{k}" for k in SETUP_CASES]
    + [f"encode_{k}" for k in ENCODE_CASES]
)
ZSTD_SRC = pathlib.Path(__file__).resolve().parent.parent / "tpurast_torch" / "native" / "zstd.cpp"
# The cases under ThreadSanitizer: each kernel once; the plan (with raster
# and the shade kernels the kernels that share memory between threads) on
# its 24-window tile, its most greedy rounds; both again at 64x128 off the
# tile grid, where the raster's units cover sub-rectangles and the plan's
# block-wide minima and plan words run over groups of 4096 px; the shade
# kernels on float16 rows and on srgb8 rows, whose decode table each block
# copies into shared memory behind a barrier.
RACE_CASES = ["raster_grid", "resolve_grid", "sample_grid", "plan_24_windows", "vmem_take_odd_rows",
              "plane_scale_tile_grid", "raster_64x128_off_grid", "plan_64x128_off_grid", "shade_gather_off_grid",
              "shade_deferred_off_grid", "bin_random_faces", "bin_random_faces_slab", "bin_near_faces",
              *(f"setup_{k}" for k in SETUP_CASES), "encode_odd_width"]
PLANTED = "raster_output_one_tile_row_short"
PLANTED_RACE = "planted_race"
# A block whose threads read their neighbour's shared-memory word without
# the barrier between the write and the read: the race the harness must
# report (built into the ThreadSanitizer library only).
PLANTED_RACE_SRC = r"""
#include "common.cuh"
__global__ void planted_race_kernel(int* out) {
  __shared__ int word[64];
  word[threadIdx.x] = (int)threadIdx.x;
  out[threadIdx.x] = word[63 - threadIdx.x];  // no __syncthreads() before the read
}
extern "C" int tr_planted_race(int* out) {
  TR_LAUNCH(planted_race_kernel, dim3(1), dim3(64), nullptr, out);
  return 0;
}
"""


# ---------------------------------------------------------------- helpers
# (shared with tests/test_torch_csrc.py)


def bin_boxes(n, width, height, seed, huge_share, size=(1.0, 120.0), huge_size=(300.0, 900.0)):
    """n random screen boxes (F, 4) f32 over width x height, some past its
    edges, a share of them large, and (F,) valid flags, 80% set."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-60, width, n)
    y0 = rng.uniform(-40, height, n)
    big = rng.uniform(size=n) < huge_share
    w = np.where(big, rng.uniform(*huge_size, n), rng.uniform(*size, n))
    h = w * rng.uniform(0.3, 1.5, n)
    aabb = np.stack([x0, y0, x0 + w, y0 + h], axis=1).astype(np.float32)
    return torch.from_numpy(aabb), torch.from_numpy(rng.uniform(size=n) < 0.8)


def near_faces(width: int = 512, height: int = 256, seed: int = 11):
    """Faces for the binners' near-plane boxes (geometry.near_boxes): aabb
    (F, 4), valid (F,) and clip (F, 3, 4). First 1,500 random faces through
    the port's setup at width x height, seen from the origin along +Z (small
    ones in front, huge ones, and across the eye plane, as in
    tests/test_torch_geometry.py), then crafted faces, each valid with the whole screen for
    its box whatever its corners: 200 random cut faces, a face wholly
    behind the eye, faces on the eye plane (w = 0 at one, two and three
    corners), a corner exactly on the plane w = NEAR_K * z, NaN and
    infinite corners, a corner past NEAR_MAX, z of 0 and below, a z so
    small that the projection overflows, |w| past NEAR_RATIO * z, and a
    face in front whose box is the whole screen (not cut)."""
    from tpurast_torch import math3d
    from tpurast_torch.camera import Camera

    rng = np.random.default_rng(seed)

    def tris(n, lo, hi, size):
        return rng.uniform(lo, hi, (n, 1, 3)) + rng.uniform(-size, size, (n, 3, 3))

    corners = np.concatenate([tris(1000, [-3, -2, 1], [3, 2, 8], 0.4), tris(150, [-2, -1, 3], [2, 1, 6], 3.0),
                              tris(350, [-2, -2, -0.5], [2, 2, 0.5], 1.5)]).astype(np.float32)
    cam = Camera.from_target(np.zeros(3, np.float32), np.array([0.0, 0.0, 1.0], np.float32))
    vp = (math3d.perspective_inverse_depth(np.radians(80.0), width / height, 0.01) @ cam.view_matrix())
    clip = geometry.transform_corners(torch.from_numpy(corners), torch.from_numpy(vp.astype(np.float32)))
    so = geometry.triangle_setup(clip, None, corners.shape[0], width, height)
    z = np.float32(0.01)
    on_plane = np.float32(z * np.float32(geometry.NEAR_K))
    n = 200
    rand = np.concatenate([rng.uniform(-2, 2, (n, 3, 2)), np.full((n, 3, 1), z), rng.uniform(-1, 1, (n, 3, 1))],
                          axis=2)
    inf, nan = np.float32(np.inf), np.float32(np.nan)

    def face(ws, xs=(0.3, -0.2, 0.1), ys=(0.1, 0.4, -0.3), zs=(z, z, z)):
        return [[x, y, zz, w] for x, y, zz, w in zip(xs, ys, zs, ws)]

    crafted = [
        face((-1.0, -2.0, -0.5)),  # wholly behind the eye
        face((0.0, 0.5, 1.0)),  # on the eye plane at one corner
        face((0.0, 0.0, 1.0)),  # at two
        face((0.0, 0.0, 0.0)),  # at three
        face((on_plane, -0.5, 0.7)),  # a corner on w = NEAR_K * z
        face((nan, -0.5, 0.7)),
        face((-0.5, 0.7, 0.2), xs=(nan, 0.1, 0.2)),
        face((-inf, 0.5, 0.7)),
        face((-0.5, 0.7, 0.2), ys=(inf, 0.1, 0.2)),
        face((-0.5, 0.7, 0.2), xs=(3e19, 0.1, 0.2)),  # past NEAR_MAX
        face((-0.5, 0.7, 0.2), zs=(0.0, z, z)),
        face((-0.5, 0.7, 0.2), zs=(z, -z, z)),
        face((-1e-31, 1e-31, 5e-32), xs=(1e19, 0.1, 0.2), zs=(1e-35, 1e-35, 1e-35)),  # projections past float's
        face((-700.0, 500.0, 0.2)),  # |w| past NEAR_RATIO * z
        face((0.5, 0.7, 0.2)),  # in front: not cut
    ]
    extra = np.concatenate([rand, np.array(crafted)]).astype(np.float32)
    full = torch.tensor([[0.0, 0.0, float(width), float(height)]]).expand(extra.shape[0], 4)
    aabb = torch.cat([so["aabb"], full]).contiguous()
    valid = torch.cat([so["valid"], torch.ones(extra.shape[0], dtype=torch.bool)])
    return aabb, valid, torch.cat([clip, torch.from_numpy(extra)]).contiguous()


def setup_inputs(rows: int, padding: int = 0, non_finite: bool = False, ties: bool = False, width: int = 512,
                 height: int = 256, seed: int = 13):
    """The setup kernel's inputs: (corner_world (rows, 3, 3), view_proj (4,
    4), n_faces = rows - padding, width, height). Faces as
    tests/test_torch_geometry.py makes them, seen from the origin along +Z
    at width x height: small ones in front, huge ones, faces across the eye
    plane and far off screen, shuffled so that any count holds each kind.
    non_finite: faces given a NaN or an infinite corner coordinate (in x,
    y or z, one corner or all), among them the last, and at least one past
    n_faces. ties (width 512, height 256): the matrix passes x, y and z
    through with w = z, and the first faces are crafted so that rounding
    decides: a cross-product component whose exact value lies just above
    a float32 midpoint, where float64 then float32 rounds down and one
    fused multiply-add up (32,784.0 against 32,784.004), and anchors
    exactly halfway between two pixels (x 2.5 and -2.5, y 2.5), where
    round-half-even and round-half-away part."""
    from tpurast_torch import math3d
    from tpurast_torch.camera import Camera

    rng = np.random.default_rng(seed)

    def tris(n, lo, hi, size):
        return rng.uniform(lo, hi, (n, 1, 3)) + rng.uniform(-size, size, (n, 3, 3))

    k = -(-rows // 8)
    corners = np.concatenate([tris(5 * k, [-3, -2, 1], [3, 2, 8], 0.4), tris(k, [-2, -1, 3], [2, 1, 6], 3.0),
                              tris(k, [-2, -2, -0.5], [2, 2, 0.5], 1.5), tris(k, [40, -2, 2], [60, 2, 9], 0.5)])
    corners = corners[rng.permutation(corners.shape[0])[:rows]].astype(np.float32)
    if non_finite:
        bad = [np.nan, np.inf, -np.inf]
        for j, f in enumerate(range(rows - 1, 0, -max(1, rows // 40))):
            if j % 4 == 3:
                corners[f] = bad[j % 3]
            else:
                corners[f, j % 3, (j // 3) % 3] = bad[j % 3]
    cam = Camera.from_target(np.zeros(3, np.float32), np.array([0.0, 0.0, 1.0], np.float32))
    vp = math3d.perspective_inverse_depth(np.radians(80.0), width / height, 0.01) @ cam.view_matrix()
    if ties:
        assert (width, height) == (512, 256)
        vp = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 1, 0]])
        e, t = 2.0**-12, 5 * 2.0**-9  # (1 + e)^2 = 1 + 2^-11 + 2^-24: a midpoint; t: 2.5 px at width 512
        crafted = [
            # corner 0 anchors at (0, 0); e0's third component is (256 (1 + e)) (128 (1 + e)) + 2^-45
            [[-1, 1, 1], [1 + e, 1.5 * 2.0**-29, 2.0**-29], [2.0**-31, -(1 + e), 2.0**-31]],
            [[-1 + t, 1, 1], [0.5, 0.2, 1], [0.1, 0.6, 1]],  # anchor x 2.5
            [[-1 - t, 1, 1], [0.5, 0.2, 1], [0.1, 0.6, 1]],  # anchor x -2.5
            [[-1, 1 - 5 * 2.0**-8, 1], [0.5, 0.2, 1], [0.1, 0.6, 1]],  # anchor y 2.5
        ]
        corners[:len(crafted)] = np.array(crafted)
    return torch.from_numpy(corners), torch.from_numpy(vp.astype(np.float32)), rows - padding, width, height


def assert_same_bits(got, want, what: str = "") -> None:
    """got equal to want bit for bit (so -0.0 is not 0.0), NaN where want
    holds NaN: a NaN's payload is left aside, since the card's and the
    host's arithmetic write other NaN bits."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if not got.is_floating_point():
        assert torch.equal(got, want), what
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), f"{what}: NaN positions"
    assert torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan]), what


def encode_specials() -> np.ndarray:
    """Float32 values on which the encode's roundings decide, as the plain
    version (kernels/present.py encode_srgb_u8_plain) computes them on the
    CPU: every value below the transfer curve's threshold 0.0031308 whose
    product by 12.92, then by 255, is exactly k + 0.5 (a half-LSB tie), and
    so for the curve's power segment (1.055 c^(1/2.4) - 0.055) and for
    alpha's product by 255; the threshold's float32 value and the 4 values
    either side of it; NaN, the infinities, -0.0, 0, 1 and their
    neighbours, the least subnormal and the largest float of each sign."""
    def around(x, n):
        b = int(np.float32(x).view(np.int32))
        return np.arange(b - n, b + n + 1, dtype=np.int32).view(np.float32)

    def pre(c):  # the plain version's value before its rounding
        c = torch.clamp(torch.from_numpy(c), 0.0, 1.0)
        return (present.linear_to_srgb(c) * 255.0).numpy()

    ties = []
    for k in range(255):
        s = (k + 0.5) / 255
        for c in (around(s / 12.92, 64), around(((s + 0.055) / 1.055) ** 2.4, 256)):
            ties.append(c[pre(c) == k + 0.5])
        a = around(s, 8)
        ties.append(a[a * np.float32(255.0) == np.float32(k + 0.5)])
    tiny, big = np.finfo(np.float32).smallest_subnormal, np.finfo(np.float32).max
    special = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, tiny, -tiny, big, -big, 0.5, -1e-30]
    return np.concatenate(ties + [around(0.0031308, 4), around(0.0, 2), around(1.0, 2),
                                  np.array(special, np.float32)]).astype(np.float32)


def encode_inputs(case: str, seed: int = 17):
    """The encode kernel's inputs for ENCODE_CASES[case]: (planes (4, Hp, Wp)
    f32, contiguous, starting the case's offset past the 16-byte grid;
    width; height). Random values in [-0.25, 1.25] (a tenth exactly 0 or
    1), or for "specials" encode_specials() in every plane, each plane's
    sequence rolled against the others so that a pixel mixes them."""
    hp, wp, width, height, offset = ENCODE_CASES[case]
    rng = np.random.default_rng(seed)
    n = hp * wp
    if case == "specials":
        v = encode_specials()
        assert v.size <= n
        vals = np.stack([np.roll(np.resize(v, n), 97 * p) for p in range(4)])
    else:
        vals = rng.uniform(-0.25, 1.25, (4, n)).astype(np.float32)
        pick = rng.random((4, n))
        vals[pick < 0.05] = 0.0
        vals[pick > 0.95] = 1.0
    buf = torch.empty(4 * n + offset, dtype=torch.float32)
    planes = buf[offset:].view(4, hp, wp)
    planes.copy_(torch.from_numpy(vals.reshape(4, hp, wp)))
    return planes, width, height


@functools.cache
def _host_powf():
    import ctypes.util

    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def assert_encode_equal(got, planes, width: int, height: int) -> int:
    """got, the encode kernel's u8 frame of planes, against the plain
    version's arithmetic (encode_srgb_u8_plain) with the host's powf in
    place of torch's CPU pow: bit for bit (the emulated kernel's fast power
    is the host's exp2f(y log2f(x)), and near a rounding boundary its powf).
    Against encode_srgb_u8_plain itself within 1 LSB, at the few values
    where the two pows round to floats that land either side of a rounding
    boundary. The card's build is held to the card's torch.pow bit for bit
    on every float32 in [0, 1] (chip_smoke.py --encode-kernel). Returns the
    count of channel values where got and encode_srgb_u8_plain differ."""
    want = present.encode_srgb_u8_plain(planes, width, height)
    assert got.shape == want.shape == (4, height, width) and got.dtype == torch.uint8
    c = torch.clamp(planes[:, :height, :width], 0.0, 1.0)
    curve = c[:3] > 0.0031308
    vals, inv = torch.unique(c[:3][curve], return_inverse=True)
    powf, e = _host_powf(), float(np.float32(1.0 / 2.4))
    p = torch.zeros_like(c[:3])
    p[curve] = torch.tensor([powf(x, e) for x in vals.tolist()], dtype=torch.float32)[inv]
    host = torch.cat([torch.where(curve, 1.055 * p - 0.055, c[:3] * 12.92), c[3:]])
    assert torch.equal(got, torch.round(host * 255.0).to(torch.uint8))
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    return int((diff > 0).sum())


# The binning cases: (boxes: n, width, height, seed, huge share, small and large sizes), the grid (tiles_x,
# tiles_y, tile_w, tile_h), ty_base, pair capacity (None: bin_pairs; "half": bin_triangles with half the pairs).
BIN_CASES = {
    "random_faces": ((2000, 512, 256, 8, 0.12), (4, 8, 128, 32), 0, None),
    "random_faces_slab": ((2000, 512, 256, 8, 0.12), (4, 3, 128, 32), 2, None),
    "scan_truncated": ((2000, 512, 256, 8, 0.12), (4, 8, 128, 32), 0, "half"),
    "two_tile_passes": ((700, 3840, 2160, 5, 0.03, (1.0, 60.0), (100.0, 400.0)), (30, 270, 128, 8), 0, None),
}


def assert_resolve_close(out, g, covered):
    """chip_smoke.py's rule: integer planes exact, float planes within
    rtol 1e-5 / atol 1e-6, outside at most 0.1% of covered pixels whose l0
    flipped."""
    flip = (out[19] != g[19]) & covered
    assert int(flip.sum()) <= 0.001 * int(covered.sum())
    keep = ~flip
    for i in range(resolve.A_OUT):
        if i in resolve.INT_PLANES:
            assert torch.equal(out[i][keep], g[i][keep]), f"plane {i}"
        else:
            assert torch.allclose(out[i][keep], g[i][keep], rtol=1e-5, atol=1e-6), f"plane {i}"


def assert_resolve_bits(out, g, what: str = "") -> None:
    """The resolve kernel against its plain version bit for bit (NaN where
    it has NaN), every plane a face row's field reaches included, but the
    two planes whose last bit is a library function's: the mip fraction
    (13, log2) and the probe span (17, sqrt), where torch's CPU log2 and
    sqrt round unlike glibc's, within rtol 1e-5 / atol 1e-6."""
    lib = (13, 17)
    rest = [i for i in range(resolve.A_OUT) if i not in lib]
    assert_same_bits(out[rest], g[rest], what)
    for i in lib:
        assert torch.equal(torch.isnan(out[i]), torch.isnan(g[i])), f"{what}: plane {i}'s NaN positions"
        ok = ~torch.isnan(g[i])
        assert torch.allclose(out[i][ok], g[i][ok], rtol=1e-5, atol=1e-6), f"{what}: plane {i}"


def assert_shade_close(out, want, covered):
    """The shade kernels' budget against their plain versions on the CPU:
    the same order of operations, so the f32 planes agree bit for bit
    except where torch's CPU pow (specular term, srgb8 decode table) or
    log2 (the deferred mip level) rounds unlike glibc's, at most 0.5% of
    the covered pixels; those stay within 1 LSB after the sRGB u8 encode.
    Uncovered pixels hold the clear color exactly. Returns the pixels at 1
    LSB."""
    h, w = out.shape[1:]
    assert torch.equal(out[:, ~covered], want[:, ~covered])
    differ = (out != want).any(dim=0)
    assert int(differ.sum()) <= 0.005 * int(covered.sum()), f"{int(differ.sum())} pixels differ"
    lsb = (present.encode_srgb_u8(out, w, h).int() - present.encode_srgb_u8(want, w, h).int()).abs().amax(dim=0)
    assert int(lsb.max()) <= 1
    return int((lsb == 1).sum())


def split_rows(case, vis, setup, sc):
    """Case case of SPLIT_CASES on the frame's raster output vis, setup rows
    and uploaded scene sc: dict(vis, y_offset, setup, resolve_table,
    shade_table: the kernels' inputs; attrs, shade_rows, plain_vis: the
    plain versions', the packed tables from the same two parts
    (pack_resolve_attrs, pack_shade_rows) and vis with the face ids past
    the last row marked uncovered)."""
    atlas = dict(sc["atlas"])
    if case == "no_pages":
        for k in ("page_origins", "page_sizes", "page_n_mips"):
            atlas.pop(k, None)
    corners = (sc["corner_world"], sc["corner_normal"], sc["corner_uv"], sc["face_tex"], atlas)
    vis, y_offset = vis.clone(), 0
    rows, n = setup.shape[0], sc["n_faces"]
    fid = vis[1]
    covered = torch.nonzero(fid.reshape(-1) >= 0)[:, 0]
    if case == "slab":
        vis, y_offset = vis[:, 32:].contiguous(), 32
    elif case == "padded_faces":
        assert rows > n
        pad = torch.arange(covered.numel()) % (rows - n + 2)  # n .. rows + 1
        fid.view(-1)[covered[::2]] = (n + pad[::2]).float()
    elif case == "last_row":
        fid.view(-1)[covered[::3]] = float(rows - 1)
    plain_vis = vis.clone()
    plain_vis[1][plain_vis[1] >= rows] = -1.0
    return dict(vis=vis, y_offset=y_offset, setup=setup, resolve_table=resolve.scene_table(*corners),
                shade_table=shade.scene_table(*corners), attrs=resolve.pack_resolve_attrs(setup, *corners),
                shade_rows=shade.pack_shade_rows(setup, *corners), plain_vis=plain_vis)


def texture_grid_gbuf(n_tex, cols, seed=11):
    """One 32x128 tile over a cols-wide grid of n_tex textures, as
    tests/test_sampler_hard_paths.py's many-texture scenes give the plan:
    each cell of pixels samples its own 256x64 mip rect of the page (own
    and parent at the same size; wider than X_WRAP_LIM and shorter than
    Y_WRAP_LIM, so both anchor rules run, and wider than a plan word's
    x band and taller than its y band; rects 512 columns and 128 rows
    apart, so a window holds one), with random uv and a footprint of up
    to a few probes; one pixel in 11 is unmatched."""
    rng = np.random.default_rng(seed)
    h, w = 32, 128
    rows = -(-n_tex // cols)
    yy, xx = np.mgrid[0:h, 0:w]
    tex = np.minimum((yy * rows // h) * cols + xx * cols // w, n_tex - 1)
    g = np.zeros((resolve.A_OUT, h, w), np.float32)
    g[6] = rng.uniform(0.0, 1.0, (h, w))
    g[7] = rng.uniform(0.0, 1.0, (h, w))
    g[9] = g[11] = 256.0
    g[10] = g[12] = 64.0
    g[14] = rng.uniform(-0.04, 0.04, (h, w))
    g[15] = rng.uniform(-0.04, 0.04, (h, w))
    g[16] = (rng.integers(0, 11, (h, w)) > 0).astype(np.float32)
    g[17] = rng.uniform(0.5, 2.0, (h, w))
    g[20] = g[22] = 8.0 + 128.0 * (tex // 8)
    g[21] = g[23] = 24.0 + 512.0 * (tex % 8)
    return torch.from_numpy(g)


def poisoned_gbuf(planes, value):
    """Two tiles of textures (texture_grid_gbuf), a matched pixel of the
    first with value (a float string: "nan", "inf", "-inf") in planes."""
    g = torch.cat([texture_grid_gbuf(6, 3), texture_grid_gbuf(6, 3, seed=12)], dim=2)
    g[16, 5, 17] = 1.0
    for i in planes:
        g[i, 5, 17] = float(value)
    return g


def sanitized_library(out: pathlib.Path, sanitizer: str) -> pathlib.Path:
    """csrc/*.cu built with g++ for the host emulation under the sanitizer
    ("address" or "thread"; the latter with the planted race beside them):
    one g++ per source, all started together, then the link."""
    cxx = shutil.which("g++")
    flags = ["-std=c++20", "-O1", "-g", *SANITIZERS[sanitizer]["flags"], "-ffp-contract=off", "-fPIC", "-pthread",
             "-DTR_HOST_EMU", f"-I{_build.CSRC}"]
    srcs = sorted(_build.CSRC.glob("*.cu"))
    if sanitizer == "address":
        srcs.append(ZSTD_SRC)
    if sanitizer == "thread":
        srcs.append(out.parent / "planted_race.cu")
        srcs[-1].write_text(PLANTED_RACE_SRC)
    objs = [out.parent / f"{p.stem}.o" for p in srcs]

    def run(cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, f"{' '.join(cmd)}\n{proc.stderr}"

    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        list(pool.map(run, [[cxx, *flags, "-x", "c++", "-c", str(p), "-o", str(o)] for p, o in zip(srcs, objs)]))
    run([cxx, "-shared", SANITIZERS[sanitizer]["flags"][0], "-pthread", *map(str, objs), "-o", str(out)])
    return out


def runtime_path(sanitizer: str) -> str:
    """The sanitizer's runtime library as g++ finds it ("" where it has none)."""
    name = SANITIZERS[sanitizer]["runtime"]
    path = subprocess.run(["g++", f"-print-file-name={name}"], capture_output=True, text=True).stdout.strip()
    return path if os.path.isabs(path) else ""


def start_cases(lib: pathlib.Path, sanitizer: str, cases, out_json: pathlib.Path) -> subprocess.Popen:
    """This file as a subprocess with the sanitizer's runtime preloaded,
    started: the cases' verdicts land in out_json, its report in stderr."""
    env = dict(os.environ, LD_PRELOAD=runtime_path(sanitizer), TPURAST_NATIVE="0", **SANITIZERS[sanitizer]["env"])
    return subprocess.Popen([sys.executable, __file__, str(lib), str(out_json), *cases], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


# ------------------------------------------------- the subprocess' cases


def exact(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t in an allocation of exactly its bytes."""
    return t.detach().clone(memory_format=torch.contiguous_format)


class Cases:
    """The cases, run against the ASan library lib."""

    def __init__(self, lib):
        self.lib = lib
        self.scene = build_orbit_scene(seed=2, **SCENE)
        self._frames = {}

    # -- a frame's inputs, through the plain versions

    def frame_inputs(self, size: str, tile: str = "32x128") -> dict:
        """The frame's setup and bins at a tile shape ("HxW")."""
        if (size, tile) not in self._frames:
            w, h = SIZES[size]
            th, tw = map(int, tile.split("x"))
            r = Renderer(self.scene, RendererConfig(width=w, height=h, tile_h=th, tile_w=tw), device="cpu")
            kw, sc = r._frame_kwargs, r.scene
            vp, cp = r.frame_uniforms(orbit_track(8)[CAMERA])
            so = geometry.triangle_setup(geometry.transform_corners(sc["corner_world"], vp), None, sc["n_faces"],
                                         kw["width"], kw["height"])
            tiles = dict(tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"])
            bins = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"])
            light = dict(light_direction=kw["light_direction"], light_color=kw["light_color"],
                         ambient_amount=kw["ambient_amount"], specular_power=kw["specular_power"],
                         clear_color=kw["clear_color"], blend=kw["blend"])
            self._frames[size, tile] = dict(kw=kw, sc=sc, cp=cp, so=so, bins=bins, tiles=tiles,
                                            ma=kw["max_anisotropy"], light=light)
        return self._frames[size, tile]

    def frame(self, size: str, tile: str = "32x128") -> dict:
        """frame_inputs and the plain versions' face ids, attributes and
        G-buffer."""
        f = self.frame_inputs(size, tile)
        if "g" not in f:
            so, sc = f["so"], f["sc"]
            f["vis"] = raster.rasterize_tiles_plain(so["setup"], so["aabb"], f["bins"]["pair_faces"],
                                                    f["bins"]["offsets"], clear_depth=f["kw"]["clear_depth"],
                                                    **f["tiles"])
            f["attrs"] = resolve.pack_resolve_attrs(so["setup"], sc["corner_world"], sc["corner_normal"],
                                                    sc["corner_uv"], sc["face_tex"], sc["atlas"])
            f["rows"] = (so["setup"], sc["resolve_table"])
            f["g"] = resolve.resolve_gbuffer_plain(f["vis"], f["attrs"], max_anisotropy=f["ma"])
        return f

    # -- one launch each, every buffer exact

    def emu_raster(self, so, bins, tiles, clear_depth=0.0, row0=0, short_rows=0):
        """The emulated raster kernel's (2, Hp, Wp) output; short_rows
        takes that many rows off the output's allocation (the planted
        case)."""
        hp, wp = tiles["tiles_y"] * tiles["tile_h"], tiles["tiles_x"] * tiles["tile_w"]
        keys, work, out = raster.kernel_buffers(tiles["tile_h"], tiles["tile_w"], tiles["tiles_x"], tiles["tiles_y"],
                                                bins["pair_faces"].numel(), torch.device("cpu"))
        if short_rows:
            out = torch.empty(2 * hp * wp - short_rows * wp)
        args = [exact(so["setup"]), exact(so["aabb"]), exact(bins["pair_faces"]), exact(bins["offsets"])]
        err = self.lib.tr_raster(*(a.data_ptr() for a in args), bins["pair_faces"].numel(), tiles["tiles_x"],
                                 tiles["tiles_y"], tiles["tile_h"], tiles["tile_w"], row0, clear_depth,
                                 keys.data_ptr(), work.data_ptr(), work.numel(), out.data_ptr(), None, None, None)
        assert err == 0
        return out.reshape(2, hp, wp)

    def emu_resolve(self, vis, rows, y_offset=0, max_anisotropy=16):
        """rows: the (F, 24) setup rows and the (F, 80) resolve table."""
        vis, setup, table = exact(vis), exact(rows[0]), exact(rows[1])
        out = torch.empty((resolve.A_OUT,) + tuple(vis.shape[1:]))
        err = self.lib.tr_resolve(vis.data_ptr(), setup.data_ptr(), table.data_ptr(), setup.shape[0], vis.shape[1],
                                  vis.shape[2], y_offset, max_anisotropy, out.data_ptr(), None, None, None)
        assert err == 0
        return out

    def emu_plan(self, g, tiles, max_anisotropy=16):
        g = exact(g)
        table = torch.empty((tiles["tiles_x"] * tiles["tiles_y"], 8, 128), dtype=torch.int32)
        assign = torch.empty((2,) + tuple(g.shape[1:]))
        residual_px = torch.zeros((), dtype=torch.int32)
        scratch = sampler.plan_scratch(tiles["tile_h"], tiles["tile_w"], g.shape[1], g.shape[2], "cpu")
        err = self.lib.tr_plan(g.data_ptr(), tiles["tiles_x"], tiles["tiles_y"], tiles["tile_h"], tiles["tile_w"],
                               sampler.rc_for(tiles["tile_h"]), max_anisotropy, table.data_ptr(), assign.data_ptr(),
                               residual_px.data_ptr(), None if scratch is None else scratch.data_ptr(), None)
        assert err == 0
        return table, assign, int(residual_px)

    def check_plan(self, g, tiles, max_anisotropy=16):
        plan = sampler.plan_tiles_plain(g, max_anisotropy=max_anisotropy, **tiles)
        table, assign, residual_px = self.emu_plan(g, tiles, max_anisotropy)
        assert torch.equal(table, plan["table"])
        assert torch.equal(assign, plan["assign"])
        assert residual_px == int(plan["residual_px"])
        return plan

    # -- the cases

    def raster(self, size, tile="32x128"):
        f = self.frame(size, tile)
        out = self.emu_raster(f["so"], f["bins"], f["tiles"], f["kw"]["clear_depth"])
        assert torch.equal(out, f["vis"])
        w, h = SIZES[size]
        covered = out[1] >= 0
        assert int(covered.sum()) > 500
        assert int(covered[h:].sum() + covered[:h, w:].sum()) > 0 if size == "off_grid" else True

    def resolve(self, size):
        f = self.frame(size)
        assert_resolve_close(self.emu_resolve(f["vis"], f["rows"], max_anisotropy=f["ma"]), f["g"], f["vis"][1] >= 0)

    def plan(self, size, tile="32x128"):
        f = self.frame(size, tile)
        plan = self.check_plan(f["g"], f["tiles"], f["ma"])
        assert int((plan["cls"] == sampler.CLS_WINDOWED).sum()) >= (4 if size == "grid" else 1)

    def sample(self, size):
        f = self.frame(size)
        g, tiles, ma, light = f["g"], f["tiles"], f["ma"], f["light"]
        plan = sampler.plan_tiles_plain(g, max_anisotropy=ma, **tiles)
        page = sampler.interleave_page(f["sc"]["atlas"]["page"].contiguous())
        sampler._check_page(page)
        want = sampler.sample_tiles_plain(g, page, plan, f["cp"], max_anisotropy=ma, **tiles, **light)
        args = [exact(g), page, exact(plan["table"]), exact(f["cp"]),
                torch.tensor(shade.shade_params(**light), dtype=torch.float32)]
        out = torch.empty((4,) + tuple(g.shape[1:]))
        err = self.lib.tr_sample(args[0].data_ptr(), page.data_ptr(), page.shape[2], args[2].data_ptr(),
                                 args[3].data_ptr(), tiles["tiles_x"], tiles["tiles_y"], tiles["tile_h"],
                                 tiles["tile_w"], ma, args[4].data_ptr(), out.data_ptr(), None, None, None)
        assert err == 0
        hp, wp = g.shape[1:]
        lsb = (present.encode_srgb_u8(out, wp, hp).int() - present.encode_srgb_u8(want, wp, hp).int()).abs().max()
        assert int(lsb) <= 1
        assert torch.equal(out[:, g[16] == 0], want[:, g[16] == 0])

    def slab(self, which, kernel):
        """A slab inside the frame is held to the plain whole frame's rows
        (tests/test_torch_csrc.py holds the plain slab to them bit for bit);
        the slab below the frame to its own plain version."""
        f = self.frame("grid")
        row0, rows = SLABS[which]
        th, so = f["kw"]["tile_h"], f["so"]
        tiles = dict(f["tiles"], tiles_y=rows)
        bins = geometry.bin_pairs(so["aabb"], so["valid"], tiles["tiles_x"], rows, tiles["tile_w"], th, ty_base=row0)
        inside = row0 + rows <= f["tiles"]["tiles_y"]
        px = slice(row0 * th, (row0 + rows) * th)
        if inside:
            vis, g = f["vis"][:, px], f["g"][:, px]
        else:
            vis = raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"],
                                               tile_row_offset=row0, **tiles)
            g = resolve.resolve_gbuffer_plain(vis, f["attrs"], max_anisotropy=16, tile_row_offset=row0, tile_h=th)
        if kernel == "raster":
            assert torch.equal(self.emu_raster(so, bins, tiles, row0=row0), vis)
            assert int((vis[1] >= 0).sum()) > (500 if inside else -1)
        else:
            assert_resolve_close(self.emu_resolve(vis, f["rows"], y_offset=row0 * th), g, vis[1] >= 0)

    def shade(self, kernel, size):
        """tr_shade_gbuffer on float16 rows or tr_shade_deferred on srgb8
        rows (with its decode table) over the frame's padded tiles, the
        atlas offsets of a third of the pixels (gather: the last multiple
        of 256 below the row count) or faces (deferred: the last row) moved
        to the table's end, so that their rows run past it and clamp to its
        last row; unclamped, the first rows past the end fall in ASan's
        redzone."""
        f = self.frame(size)
        dtype = "float16" if kernel == "gather" else "srgb8"
        fmt = "srgb8" if dtype == "srgb8" else "float"
        texels = exact(texels_tensor(self.scene.atlas.texels, dtype, "cpu"))
        n = texels.shape[0]
        code, lut = shade._check_rows(texels, fmt, shade.srgb_table("cpu"))
        light, cp, ma = f["light"], exact(f["cp"]), f["ma"]
        params = torch.tensor(shade.shade_params(**light), dtype=torch.float32)
        fid = exact(f["vis"][1].to(torch.int32))
        fid_f = exact(f["vis"][1])
        out = torch.empty((4,) + tuple(fid.shape))
        lut = None if lut is None else exact(lut)
        lut_ptr = None if lut is None else lut.data_ptr()
        if kernel == "gather":
            g = f["g"].clone()
            g[8, torch.remainder(fid, 3) == 1] = float(n // 256)
            want = shade.shade_gbuffer_plain(g, texels, cp, max_anisotropy=ma, texel_format=fmt, **light)
            g = exact(g)
            err = self.lib.tr_shade_gbuffer(g.data_ptr(), texels.data_ptr(), n, code, lut_ptr, cp.data_ptr(),
                                            fid.shape[0], fid.shape[1], ma, params.data_ptr(), out.data_ptr(), None,
                                            None, None)
        else:
            so, sc = f["so"], f["sc"]
            rows = shade.pack_shade_rows(so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"],
                                         sc["face_tex"], sc["atlas"])
            rows[1::3, shade.ROW_TEXINFO:shade.ROW_TEXINFO + 16].view(torch.int32).fill_(n - 1)
            want = shade.shade_deferred_plain(fid, rows, texels, cp, max_anisotropy=ma, texel_format=fmt, **light)
            setup, table = exact(rows[:, :24]), exact(rows[:, 24:])
            err = self.lib.tr_shade_deferred(fid_f.data_ptr(), setup.data_ptr(), table.data_ptr(), rows.shape[0],
                                             texels.data_ptr(), n, code, lut_ptr, cp.data_ptr(), fid.shape[0],
                                             fid.shape[1], 0, ma, params.data_ptr(), out.data_ptr(), None, None, None)
        assert err == 0
        w, h = SIZES[size]
        covered = fid >= 0
        assert int(covered[h:].sum() + covered[:h, w:].sum()) > 0 if size == "off_grid" else True
        assert_shade_close(out, want, covered)

    def split_rows(self, case):
        """The resolve kernel and the deferred kernel (srgb8 rows) on the
        256x128 frame's split_rows(case): the setup rows, the face tables,
        the face ids and every output exact-size, so that a row read past
        either table's end falls in ASan's redzone; held to the plain
        versions on the packed tables (assert_resolve_bits,
        assert_same_bits)."""
        f = self.frame("grid")
        c = split_rows(case, f["vis"], f["so"]["setup"], f["sc"])
        vis, plain_vis, y0 = c["vis"], c["plain_vis"], c["y_offset"]
        covered = plain_vis[1] >= 0
        assert int(covered.sum()) > 500
        th = f["kw"]["tile_h"]
        g = self.emu_resolve(vis, (c["setup"], c["resolve_table"]), y_offset=y0)
        want = resolve.resolve_gbuffer_plain(plain_vis, c["attrs"], max_anisotropy=16, tile_row_offset=y0 // th,
                                             tile_h=th)
        assert_resolve_bits(g, want, f"resolve, {case}")
        texels = exact(texels_tensor(self.scene.atlas.texels, "srgb8", "cpu"))
        code, lut = shade._check_rows(texels, "srgb8", shade.srgb_table("cpu"))
        light, cp = f["light"], exact(f["cp"])
        params = torch.tensor(shade.shade_params(**light), dtype=torch.float32)
        fid, setup, table, lut = exact(vis[1]), exact(c["setup"]), exact(c["shade_table"]), exact(lut)
        out = torch.empty((4,) + tuple(fid.shape))
        err = self.lib.tr_shade_deferred(fid.data_ptr(), setup.data_ptr(), table.data_ptr(), setup.shape[0],
                                         texels.data_ptr(), texels.shape[0], code, lut.data_ptr(), cp.data_ptr(),
                                         fid.shape[0], fid.shape[1], y0, 16, params.data_ptr(), out.data_ptr(), None,
                                         None, None)
        assert err == 0
        want = shade.shade_deferred_plain(plain_vis[1].to(torch.int32), c["shade_rows"], texels, cp, max_anisotropy=16,
                                          y_offset=y0, texel_format="srgb8", **light)
        assert_same_bits(out, want, f"deferred, {case}")

    def bin(self, case):
        """tr_bin without near-plane boxes (clip and faces null) on
        BIN_CASES[case], every input, output and the scratch
        (tr_bin_scratch ints) a tensor of exactly its size, against the plain
        binner: offsets, counts and overflow exactly, the pairs on the live
        prefix (bin_triangles: its whole buffer)."""
        boxes, (tx, ty, tw, th), base, cap = BIN_CASES[case]
        aabb, valid = bin_boxes(*boxes)
        grid = (aabb, valid, tx, ty, tw, th)
        if cap == "half":
            cap = int(geometry.bin_pairs(*grid, ty_base=base)["offsets"][-1]) // 2
        scan = cap is not None
        want = geometry.bin_triangles(*grid, cap, ty_base=base) if scan else geometry.bin_pairs(*grid, ty_base=base)
        f = aabb.shape[0]
        args = (f, tx, ty, tw, th, geometry.TILES_PER_FACE, geometry.HUGE_BUDGET, base, int(not scan))
        n_scratch = self.lib.tr_bin_scratch(*args)
        slots = geometry.TILES_PER_FACE * f + min(geometry.HUGE_BUDGET, f) * tx * ty
        aabb, valid = exact(aabb), exact(valid)
        faces = torch.empty((cap if scan else slots,), dtype=torch.int32)
        tiles = None if scan else torch.empty((slots,), dtype=torch.int32)
        offsets = torch.empty((tx * ty + 1,), dtype=torch.int32)
        counts = torch.empty((tx * ty,), dtype=torch.int32)
        overflow = torch.empty((), dtype=torch.int32)
        scratch = torch.empty((n_scratch,), dtype=torch.int32)
        err = self.lib.tr_bin(aabb.data_ptr(), valid.data_ptr(), None, 0, 0, *args, faces.numel(), faces.data_ptr(),
                              None if tiles is None else tiles.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
                              overflow.data_ptr(), None, scratch.data_ptr(), n_scratch, None)
        assert err == 0
        n = int(want["offsets"][-1])
        assert n > 500 and (int(want["overflow"]) > 0 or case == "random_faces_slab")
        for k, got in (("offsets", offsets), ("counts", counts), ("overflow", overflow)):
            assert torch.equal(got, want[k]), k
        assert torch.equal(faces, want["pair_faces"]) if scan else torch.equal(faces[:n], want["pair_faces"][:n])
        assert scan or torch.equal(tiles[:n], want["pair_tiles"][:n])

    def bin_near(self, scan: bool):
        """tr_bin with near-plane boxes on near_faces at 512x256 in 32x128
        tiles, every input (the clip corners too), output and the scratch a
        tensor of exactly its size, against the plain binner with near=:
        offsets, counts, overflow and the face counts exactly, the pairs as
        in ``bin``."""
        aabb, valid, clip = near_faces()
        tx, ty, tw, th, f = 4, 8, 128, 32, aabb.shape[0]
        grid, near = (aabb, valid, tx, ty, tw, th), (clip, 512, 256)
        cap = int(geometry.bin_pairs(*grid, near=near)["offsets"][-1]) // 2 if scan else None
        want = geometry.bin_triangles(*grid, cap, near=near) if scan else geometry.bin_pairs(*grid, near=near)
        args = (f, tx, ty, tw, th, geometry.TILES_PER_FACE, geometry.HUGE_BUDGET, 0, int(not scan))
        n_scratch = self.lib.tr_bin_scratch(*args)
        slots = geometry.TILES_PER_FACE * f + min(geometry.HUGE_BUDGET, f) * tx * ty
        aabb, valid, clip = exact(aabb), exact(valid), exact(clip)
        out = dict(pair_faces=torch.empty((cap if scan else slots,), dtype=torch.int32),
                   offsets=torch.empty((tx * ty + 1,), dtype=torch.int32),
                   counts=torch.empty((tx * ty,), dtype=torch.int32), overflow=torch.empty((), dtype=torch.int32),
                   faces=torch.empty((2,), dtype=torch.int32))
        tiles = None if scan else torch.empty((slots,), dtype=torch.int32)
        scratch = torch.empty((n_scratch,), dtype=torch.int32)
        err = self.lib.tr_bin(aabb.data_ptr(), valid.data_ptr(), clip.data_ptr(), 512, 256, *args,
                              out["pair_faces"].numel(), out["pair_faces"].data_ptr(),
                              None if tiles is None else tiles.data_ptr(), out["offsets"].data_ptr(),
                              out["counts"].data_ptr(), out["overflow"].data_ptr(), out["faces"].data_ptr(),
                              scratch.data_ptr(), n_scratch, None)
        assert err == 0
        n = int(want["offsets"][-1])
        assert n > 500 and int(want["cut_faces"]) > 20
        for k in ("offsets", "counts", "overflow"):
            assert torch.equal(out[k], want[k]), k
        assert out["faces"].tolist() == [int(want["cut_faces"]), int(want["huge_faces"])]
        got = out["pair_faces"] if scan else out["pair_faces"][:n]
        assert torch.equal(got, want["pair_faces"] if scan else want["pair_faces"][:n])
        assert scan or torch.equal(tiles[:n], want["pair_tiles"][:n])

    def setup(self, case):
        """tr_setup on setup_inputs(*SETUP_CASES[case]), the corners and
        every output a tensor of exactly its size, against
        transform_corners and triangle_setup: all five outputs bit for
        bit."""
        corners, vp, n_faces, w, h = setup_inputs(*SETUP_CASES[case])
        clip = geometry.transform_corners(corners, vp)
        want = dict(clip=clip, **geometry.triangle_setup(clip, None, n_faces, w, h))
        f = corners.shape[0]
        out = dict(clip=torch.empty((f, 3, 4)), setup=torch.empty((f, geometry.SETUP_WIDTH)),
                   valid=torch.empty((f,), dtype=torch.bool), aabb=torch.empty((f, 4)), det=torch.empty((f,)))
        corners, vp = exact(corners), exact(vp)
        err = self.lib.tr_setup(corners.data_ptr(), vp.data_ptr(), f, n_faces, w, h,
                                *(out[k].data_ptr() for k in ("clip", "setup", "valid", "aabb", "det")), None)
        assert err == 0
        for k, v in out.items():
            assert_same_bits(v, want[k], k)
        assert f < 64 or int(want["valid"].sum()) > 0

    def encode(self, case):
        """tr_encode on encode_inputs(case), the planes an allocation of
        exactly their bytes (and the case's offset before them) and the
        output an exact-size tensor, against
        encode_srgb_u8_plain (assert_encode_equal); then into guard bands:
        the output a view inside a buffer of 0xA5 bytes, on and off the
        4-byte grid, every margin byte intact and the same bytes."""
        planes, w, h = encode_inputs(case)
        hp, wp = planes.shape[1:]
        out = torch.empty((4, h, w), dtype=torch.uint8)
        assert self.lib.tr_encode(planes.data_ptr(), hp, wp, w, h, out.data_ptr(), None) == 0
        assert_encode_equal(out, planes, w, h)
        for shift in (0, 3):
            margin = 64 + shift
            buf = torch.full((out.numel() + 2 * margin,), 0xA5, dtype=torch.uint8)
            view = buf[margin:margin + out.numel()].view(out.shape)
            assert self.lib.tr_encode(planes.data_ptr(), hp, wp, w, h, view.data_ptr(), None) == 0
            assert bool((buf[:margin] == 0xA5).all()) and bool((buf[margin + out.numel():] == 0xA5).all())
            assert torch.equal(view, out)

    def plan_24_windows(self):
        plan = self.check_plan(texture_grid_gbuf(24, 6), dict(tiles_x=1, tiles_y=1, tile_h=32, tile_w=128))
        assert int(plan["cls"][0]) == sampler.CLS_WINDOWED and int(plan["n_used"][0]) >= 24

    def plan_poisoned(self, planes, value):
        plan = self.check_plan(poisoned_gbuf(planes, value), dict(tiles_x=2, tiles_y=1, tile_h=32, tile_w=128))
        assert plan["cls"].tolist() == [sampler.CLS_RESIDUAL, sampler.CLS_WINDOWED]

    def vmem_take(self, rows, n, offset):
        rng = np.random.default_rng(rows + n)
        table = torch.from_numpy(rng.uniform(-1, 1, (rows, probes.TAKE_WIDTH)).astype(np.float32))
        idx = torch.from_numpy(rng.integers(-3, rows + 3, n + offset).astype(np.int32))
        # An index array off the 16-byte grid is a view one int into an
        # allocation whose end is the view's end.
        idx_view = idx[offset:]
        out = torch.empty((n,))
        assert self.lib.tr_vmem_take(table.data_ptr(), rows, idx_view.data_ptr(), n, out.data_ptr(), None) == 0
        assert torch.equal(out, probes.vmem_take_plain(table, idx_view))

    def plane_scale(self, shape, plane, block_h, block_w):
        src = torch.from_numpy(np.random.default_rng(4).uniform(-2, 2, shape).astype(np.float32))
        want = probes.plane_scale_plain(src, plane, block_h=block_h, block_w=block_w)
        for threads in (0, 32, 100):
            out = torch.empty(want.shape)
            assert self.lib.tr_plane_scale(src.data_ptr(), plane, shape[1], shape[2], block_h, block_w, threads,
                                           out.data_ptr(), None) == 0
            assert torch.equal(out, want), f"{threads} threads"

    def zstd_frames(self):
        import zstandard

        rng = np.random.default_rng(7)
        data = (" ".join(str(int(v)) for v in rng.integers(0, 999, 12000)).encode()
                + rng.integers(0, 4, 60000, dtype=np.uint8).tobytes())
        frames = [zstandard.ZstdCompressor(level=lvl, write_checksum=True).compress(data) for lvl in (3, 19)]
        fn = self.lib.zstd_decompress
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        fn.restype = ctypes.c_int64

        def run(blob: bytes, cap: int) -> tuple[int, bytes]:
            src = torch.frombuffer(bytearray(blob), dtype=torch.uint8).clone()
            dst = torch.empty(cap, dtype=torch.uint8)
            n = fn(src.data_ptr(), len(blob), dst.data_ptr(), cap)
            return n, dst[: max(n, 0)].numpy().tobytes()

        for frame in frames:
            assert run(frame, len(data)) == (len(data), data)
            assert run(frame, len(data) - 1)[0] < 0
            for _ in range(300):
                blob = bytearray(frame)
                if rng.integers(2):
                    del blob[int(rng.integers(1, len(blob))):]
                else:
                    for _ in range(int(rng.integers(1, 4))):
                        blob[int(rng.integers(len(blob)))] ^= 1 << int(rng.integers(8))
                n, out = run(bytes(blob), len(data))
                assert n < 0 or out == data, n

    def planted(self):
        f = self.frame_inputs("grid")
        self.emu_raster(f["so"], f["bins"], f["tiles"], short_rows=f["kw"]["tile_h"])

    def planted_race(self):
        out = torch.empty(64, dtype=torch.int32)
        assert self.lib.tr_planted_race(ctypes.c_void_p(out.data_ptr())) == 0

    def run(self, case: str) -> None:
        for k in ("raster", "resolve", "plan", "sample"):
            for s in SIZES:
                if case == f"{k}_{s}":
                    return getattr(self, k)(s)
            for s in SLABS:
                if case == f"{k}_{s}":
                    return self.slab(s, k)
            for t, s in LARGE_TILES:
                if case == f"{k}_{t}_{s}":
                    return getattr(self, k)(s, t)
        table = {
            "plan_24_windows": self.plan_24_windows,
            "plan_nan_under_a_matched_pixel": lambda: self.plan_poisoned((6, 7, 14, 15, 17), "nan"),
            "plan_inf_under_a_matched_pixel": lambda: self.plan_poisoned((20, 21, 22, 23), "inf"),
            "vmem_take_odd_rows": lambda: self.vmem_take(4095, 999, 0),
            "vmem_take_outside_the_table": lambda: self.vmem_take(33, 130, 0),
            "vmem_take_unaligned_idx": lambda: self.vmem_take(33, 130, 1),
            # A 3-plane buffer, plane 1 (its offset off the 16-byte grid),
            # an odd width: tile-grid and row-band blocks; one plane of
            # 15 x 23 in 5 x 2 blocks.
            "plane_scale_tile_grid": lambda: self.plane_scale((3, 67, 381), 1, 32, 128),
            "plane_scale_row_band": lambda: self.plane_scale((3, 67, 381), 1, 32, 381),
            "plane_scale_one_plane": lambda: self.plane_scale((1, 15, 23), 0, 5, 2),
            "zstd_corrupt_and_truncated_frames": self.zstd_frames,
            "shade_gather_off_grid": lambda: self.shade("gather", "off_grid"),
            "shade_deferred_off_grid": lambda: self.shade("deferred", "off_grid"),
            **{f"split_rows_{k}": functools.partial(self.split_rows, k) for k in SPLIT_CASES},
            **{f"bin_{k}": functools.partial(self.bin, k) for k in BIN_CASES},
            "bin_near_faces": lambda: self.bin_near(False),
            "bin_near_faces_scan": lambda: self.bin_near(True),
            **{f"setup_{k}": functools.partial(self.setup, k) for k in SETUP_CASES},
            **{f"encode_{k}": functools.partial(self.encode, k) for k in ENCODE_CASES},
            PLANTED: self.planted,
            PLANTED_RACE: self.planted_race,
        }
        return table[case]()


def main(argv) -> int:
    lib_path, out_path, cases = argv[0], argv[1], argv[2:]
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    for name, n_in in _build.COUNTS.items():
        getattr(lib, name).argtypes = [ctypes.c_int] * n_in
        getattr(lib, name).restype = ctypes.c_longlong
    runner = Cases(lib)
    verdicts = {}
    for case in cases:
        try:
            runner.run(case)
            verdicts[case] = "ok"
        except AssertionError as e:
            verdicts[case] = f"disagrees with its plain version: {e!r}"
        pathlib.Path(out_path).write_text(json.dumps(verdicts))
    return 0


# ------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(sanitizer, "cases" or "planted"): (exit code, stderr, verdicts)}:
    both libraries built, then the four subprocesses run side by side. A
    sanitizer whose runtime g++ lacks is left out."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emulated kernels")
    sanitizers = [k for k in SANITIZERS if runtime_path(k)]
    dirs = {k: tmp_path_factory.mktemp(k) for k in sanitizers}  # in this thread: mktemp is not thread-safe
    with concurrent.futures.ThreadPoolExecutor(len(sanitizers) or 1) as pool:
        libs = dict(zip(sanitizers, pool.map(
            lambda k: sanitized_library(dirs[k] / "libtpurast_torch_emu.so", k), sanitizers)))
    jobs = {}
    for k, lib in libs.items():
        for what, cases in (("cases", CASES if k == "address" else RACE_CASES),
                            ("planted", [PLANTED if k == "address" else PLANTED_RACE])):
            out = lib.parent / f"{what}.json"
            jobs[k, what] = (out, start_cases(lib, k, cases, out))
    done = {}
    try:
        for key, (out, proc) in jobs.items():
            _, err = proc.communicate(timeout=600)
            done[key] = (proc.returncode, err, json.loads(out.read_text()) if out.exists() else {})
    finally:
        for _, proc in jobs.values():
            proc.kill()
    return done


def verdicts(runs, sanitizer: str) -> dict:
    """The cases' verdicts under the sanitizer, once its subprocess lived
    and reported nothing."""
    if (sanitizer, "cases") not in runs:
        pytest.skip(f"g++ has no {SANITIZERS[sanitizer]['runtime']}")
    rc, err, got = runs[sanitizer, "cases"]
    assert rc == 0 and "Sanitizer" not in err, f"the cases' subprocess under {sanitizer} exited {rc}:\n{err[-6000:]}"
    return got


def planted(runs, sanitizer: str) -> tuple[int, str]:
    if (sanitizer, "planted") not in runs:
        pytest.skip(f"g++ has no {SANITIZERS[sanitizer]['runtime']}")
    rc, err, _ = runs[sanitizer, "planted"]
    return rc, err


@pytest.mark.parametrize("case", CASES)
def test_kernel_free_of_asan_reports(runs, case):
    """Each case ran under ASan with no report (the subprocess lived) and
    agrees with its plain version."""
    got = verdicts(runs, "address")
    assert got.get(case) == "ok", got.get(case, "not run")


@pytest.mark.parametrize("case", RACE_CASES)
def test_kernel_free_of_data_races(runs, case):
    """Each case ran under ThreadSanitizer with no race reported: the
    block's threads (std::threads of the emulation, meeting at its
    barriers) touch no shared or global word in an order the barriers and
    atomics leave open. The card's racecheck looks for the same hazards
    in shared memory."""
    got = verdicts(runs, "thread")
    assert got.get(case) == "ok", got.get(case, "not run")


def test_planted_overflow_is_reported(runs):
    """The raster output one tile row short: ASan aborts the subprocess
    with a heap-buffer-overflow in the raster kernel."""
    rc, err = planted(runs, "address")
    assert rc != 0
    assert "ERROR: AddressSanitizer: heap-buffer-overflow" in err, err[-4000:]
    assert "raster" in err


def test_planted_race_is_reported(runs):
    """The planted kernel reads its neighbour's shared word with no barrier
    after the write: ThreadSanitizer ends the subprocess with a data race
    in that kernel."""
    rc, err = planted(runs, "thread")
    assert rc != 0
    assert "WARNING: ThreadSanitizer: data race" in err, err[-4000:]
    assert "planted_race_kernel" in err


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
