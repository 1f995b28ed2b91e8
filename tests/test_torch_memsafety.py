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
  * vmem_take at an odd row count, with indices outside the table, and on
    an index array off the 16-byte grid;
  * plane_scale off the 16-byte grid in its three launch geometries
    (tile-grid and row-band blocks on a 3-plane buffer, one-plane);
  * the port's Zstandard decoder (tpurast_torch/native/zstd.cpp, built
    into the ASan library beside the kernels) on frames made with the
    zstandard package at levels 3 and 19 and on 600 truncated and
    bit-flipped copies of them, each input and output in an allocation
    of exactly its size, plus an output one byte short.

ThreadSanitizer runs RACE_CASES, each kernel once (the shade kernels too:
a block's threads share the srgb8 decode table). Each case is also held
to its plain version under tests/test_torch_csrc.py's budgets. Planted
faults show that the harness catches them: the raster output one tile row
short must abort with ASan's heap-buffer-overflow, and a small kernel that
reads its neighbour's shared word without a barrier must end with
ThreadSanitizer's data race.

Time on one worker: about 80 s (the two builds side by side, then the
four subprocesses side by side: the ThreadSanitizer cases, the shade
kernels among them, take the longest, the planted ones about 5 s each).

Run the cases by hand: python tests/test_torch_memsafety.py LIB OUT.json
CASE... with LD_PRELOAD=$(g++ -print-file-name=libasan.so) (or libtsan.so
and OMP_NUM_THREADS=1), LIB built as ``sanitized_library`` builds it.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
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
CASES = (
    [f"{k}_{s}" for s in SIZES for k in ("raster", "resolve", "plan", "sample")]
    + [f"{k}_{s}" for s in SLABS for k in ("raster", "resolve")]
    + ["plan_24_windows", "plan_nan_under_a_matched_pixel", "plan_inf_under_a_matched_pixel"]
    + ["vmem_take_odd_rows", "vmem_take_outside_the_table", "vmem_take_unaligned_idx"]
    + ["plane_scale_tile_grid", "plane_scale_one_plane", "plane_scale_row_band"]
    + ["zstd_corrupt_and_truncated_frames"]
    + ["shade_gather_off_grid", "shade_deferred_off_grid"]
    + [f"{k}_{t}_{s}" for t, s in LARGE_TILES for k in ("raster", "plan")]
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
              "shade_deferred_off_grid"]
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

    def emu_resolve(self, vis, attrs, y_offset=0, max_anisotropy=16):
        vis, attrs = exact(vis), exact(attrs)
        out = torch.empty((resolve.A_OUT,) + tuple(vis.shape[1:]))
        err = self.lib.tr_resolve(vis.data_ptr(), attrs.data_ptr(), attrs.shape[0], vis.shape[1], vis.shape[2],
                                  y_offset, max_anisotropy, out.data_ptr(), None, None, None)
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
        assert_resolve_close(self.emu_resolve(f["vis"], f["attrs"], max_anisotropy=f["ma"]), f["g"], f["vis"][1] >= 0)

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
            assert_resolve_close(self.emu_resolve(vis, f["attrs"], y_offset=row0 * th), g, vis[1] >= 0)

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
            rows = exact(rows)
            err = self.lib.tr_shade_deferred(fid.data_ptr(), rows.data_ptr(), rows.shape[0], texels.data_ptr(), n,
                                             code, lut_ptr, cp.data_ptr(), fid.shape[0], fid.shape[1], 0, ma,
                                             params.data_ptr(), out.data_ptr(), None, None, None)
        assert err == 0
        w, h = SIZES[size]
        covered = fid >= 0
        assert int(covered[h:].sum() + covered[:h, w:].sum()) > 0 if size == "off_grid" else True
        assert_shade_close(out, want, covered)

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
