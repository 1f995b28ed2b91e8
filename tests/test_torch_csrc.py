"""The CUDA kernel sources (tpurast_torch/csrc) run on the CPU.

With TR_HOST_EMU defined, csrc/*.cu compile with the host C++ compiler
against csrc/host_emu.h, which runs every launch's threads on the CPU
(blocks one after another, a block's threads meeting at a barrier in
__syncthreads). The emulated kernels are held against their plain torch
versions on one frame of chip_smoke.py's scene at 256x128, with the
budgets chip_smoke.py holds the real kernels to on the card: raster
depth and face id exact; resolve integer planes exact and float planes
within rtol 1e-5 / atol 1e-6 outside l0 flips (torch's CPU sqrt and
log2 are not glibc's); plan table and assignment exact; sample within
1 LSB after the sRGB encode (torch's CPU pow is not glibc's), from the
channel-interleaved page, and the same frame bit for bit with every
covered tile forced residual. The plan kernel also runs tiles that need
24 windows, more than its 32 slots, and a NaN or an infinity under a
matched pixel. This checks the kernels'
indexing, control flow and arithmetic where no GPU exists; only the card
shows what nvcc makes of them (tests/test_torch_memsafety.py runs the same
emulation under AddressSanitizer). The emulation models threads, blocks
(one- and two-dimensional launches, the blocks one after another on one
team of threads), barriers, static shared memory, atomics
(real ones: a block's threads run concurrently), the warp-wide integer
reductions and read-only vector loads behind csrc/common.cuh's helpers,
and float4, int4 and uint2 only; a path that needs more (asynchronous
copies, dynamic shared memory, clusters) would be compiled out. The
vmem_take probe (four lanes per table row, the row number and the running
sum passed by warp shuffles) is held to its plain version bit for bit at
the shapes that stress it: an odd row count, a count of indices that fills
no whole warp or block, indices outside the table, an index array off the
16-byte grid; the plane_scale probe is held here to its plain version exactly, in the
microbenchmark's three launch geometries and at widths and block widths
that leave rows off the 16-byte grid. The raster kernel also runs the
adversarial faces of tests/test_torch_raster.py, among them a tile whose
bin holds many work units. Raster and resolve also render slabs of the
frame (a first global tile row other than 0, as parallel.py gives them):
each slab equal to its plain version under the same rules, and to the same
rows of the emulated whole frame bit for bit, also a slab that lies below
the frame. Raster, plan and sample also run at tiles past 4096 px
(LARGE_TILES: the raster's sub-rectangle units, the plan's groups of 4096
px in scratch, partial sub-rectangles, a frame off the tile grid), and the
plan on stacked many-texture tiles of 64x128.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.kernels import _build, geometry, present, probes, raster, resolve, sampler
from tpurast_torch.renderer import Renderer
from test_torch_memsafety import SCENE as SMALL_SCENE, assert_resolve_close, poisoned_gbuf, texture_grid_gbuf
from test_torch_raster import ADVERSARIAL, A_TILES_X, A_TILES_Y, AH, AW, adversarial_clip
from test_torch_scene import numpy_bc_decoders  # noqa: F401  (module-wide autouse)

@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulated kernels")
    out = tmp_path_factory.mktemp("emu") / "libtpurast_torch_emu.so"
    srcs = [str(p) for p in sorted(_build.CSRC.glob("*.cu"))]
    cmd = [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
           "-DTR_HOST_EMU", "-x", "c++", *srcs, "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def frame():
    scene = build_orbit_scene(seed=2, floor_quads=64, spheres=3, rings=16, segments=16, tex_size=128, n_textures=4)
    r = Renderer(scene, RendererConfig(width=256, height=128), device="cpu")
    kw = r._frame_kwargs
    vp, cp = r.frame_uniforms(orbit_track(8)[5])
    sc = r.scene
    clip = geometry.transform_corners(sc["corner_world"], vp)
    so = geometry.triangle_setup(clip, None, sc["n_faces"], kw["width"], kw["height"])
    bins = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"])
    return r, kw, sc, cp, so, bins


def _frame_case(frame):
    r, kw, _, _, so, bins = frame
    return dict(tile_h=kw["tile_h"], tile_w=kw["tile_w"], tiles_x=r.tiles_x, tiles_y=r.tiles_y), so, bins


def _adversarial_case(case):
    """tests/test_torch_raster.py's adversarial faces, 8x128 tiles. For
    "misbinned", the dense tile's faces (all in the frame's top 11 rows)
    are binned by hand into the last of four 32x128 tiles (full-size tiles:
    the kernel's whole shared key buffer), which none of their rectangles
    reaches."""
    clip = torch.from_numpy(adversarial_clip("dense_tile" if case == "misbinned" else case))
    so = geometry.triangle_setup(clip, None, clip.shape[0], AW, AH)
    if case == "misbinned":
        n = clip.shape[0]
        offsets = torch.zeros(5, dtype=torch.int32)
        offsets[-1] = n
        bins = dict(pair_faces=torch.arange(n, dtype=torch.int32), offsets=offsets)
        return dict(tile_h=32, tile_w=128, tiles_x=2, tiles_y=2), so, bins
    bins = geometry.bin_pairs(so["aabb"], so["valid"], A_TILES_X, A_TILES_Y, 128, 8)
    return dict(tile_h=8, tile_w=128, tiles_x=A_TILES_X, tiles_y=A_TILES_Y), so, bins


# (case, clear depth, the least covered pixel count the case must reach)
RASTER_CASES = ([("frame", 0.0, 3000)] + [(c, 0.0, 200) for c in ADVERSARIAL]
                + [("dense_tile", 0.3, 200), ("misbinned", 0.0, 0)])


@pytest.mark.parametrize("case,clear_depth,min_covered", RASTER_CASES,
                         ids=["frame"] + [f"adversarial_{c}" for c in ADVERSARIAL]
                         + ["dense_tile_clear_0.3", "misbinned"])
def test_raster_kernel(emu, frame, case, clear_depth, min_covered):
    """The frame, and tests/test_torch_raster.py's adversarial faces: among
    them a tile whose bin holds many work units (merged across units
    through the global key buffer), also with a clear depth that some
    fragments fail; and units whose every rectangle misses their tile,
    which must cover nothing."""
    args, so, bins = _frame_case(frame) if case == "frame" else _adversarial_case(case)
    if case == "dense_tile":
        assert int(bins["counts"][0]) > 8 * raster.UNIT_PAIRS
    vis = raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"],
                                       clear_depth=clear_depth, **args)
    out = _emu_raster(emu, so, bins, args, clear_depth)
    covered = int((vis[1] >= 0).sum())
    assert covered > min_covered if min_covered else covered == 0
    assert torch.equal(out, vis)


def _emu_raster(emu, so, bins, args, clear_depth=0.0, row0=0):
    """The emulated raster kernel's (2, Hp, Wp) output."""
    slots = bins["pair_faces"].numel()
    keys, work, out = raster.kernel_buffers(args["tile_h"], args["tile_w"], args["tiles_x"], args["tiles_y"], slots,
                                            "cpu")
    out.fill_(-7.0)
    err = emu.tr_raster(so["setup"].data_ptr(), so["aabb"].data_ptr(), bins["pair_faces"].data_ptr(),
                        bins["offsets"].data_ptr(), slots, args["tiles_x"], args["tiles_y"], args["tile_h"],
                        args["tile_w"], row0, clear_depth, keys.data_ptr(), work.data_ptr(), work.numel(),
                        out.data_ptr(), None)
    assert err == 0
    return out


def _emu_resolve(emu, vis, attrs, y_offset=0, max_anisotropy=16):
    out = torch.full((resolve.A_OUT,) + tuple(vis.shape[1:]), -5.0)
    err = emu.tr_resolve(vis.data_ptr(), attrs.data_ptr(), attrs.shape[0], vis.shape[1], vis.shape[2], y_offset,
                         max_anisotropy, out.data_ptr(), None)
    assert err == 0
    return out


def _attrs(frame):
    sc, so = frame[2], frame[4]
    return resolve.pack_resolve_attrs(so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"],
                                      sc["face_tex"], sc["atlas"])


def test_resolve_kernel(emu, frame):
    r, kw, sc, _, so, bins = frame
    vis = raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], tile_h=kw["tile_h"],
                                       tile_w=kw["tile_w"], tiles_x=r.tiles_x, tiles_y=r.tiles_y)
    attrs = _attrs(frame)
    g = resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=16)
    assert_resolve_close(_emu_resolve(emu, vis, attrs), g, vis[1] >= 0)


@pytest.fixture(scope="module")
def emu_frame(emu, frame):
    """The emulated raster and resolve kernels' whole frame."""
    r, kw, _, _, so, bins = frame
    vis = _emu_raster(emu, so, bins, dict(tile_h=kw["tile_h"], tile_w=kw["tile_w"], tiles_x=r.tiles_x,
                                          tiles_y=r.tiles_y))
    return vis, _emu_resolve(emu, vis, _attrs(frame))


@pytest.mark.parametrize("row0,slab_rows", [(1, 2), (3, 1), (2, 2), (4, 2)],
                         ids=["middle", "last", "lower_half", "below_the_frame"])
def test_raster_and_resolve_kernels_on_a_slab(emu, frame, emu_frame, row0, slab_rows):
    """A slab of slab_rows tile rows from frame tile row row0 (the frame
    has 4): binned with ty_base = row0, rastered and resolved at the frame's
    pixel rows. The emulated kernels equal their plain versions (raster
    exactly, resolve under chip_smoke.py's rule) and the emulated whole
    frame's rows bit for bit. A slab below the frame bins only faces whose
    box reaches the frame's last row (those crossing the eye plane)."""
    r, kw, _, _, so, _ = frame
    th = kw["tile_h"]
    args = dict(tile_h=th, tile_w=kw["tile_w"], tiles_x=r.tiles_x, tiles_y=slab_rows)
    slab = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, slab_rows, kw["tile_w"], th, ty_base=row0)
    vis = raster.rasterize_tiles_plain(so["setup"], so["aabb"], slab["pair_faces"], slab["offsets"],
                                       tile_row_offset=row0, **args)
    out = _emu_raster(emu, so, slab, args, row0=row0)
    assert torch.equal(out, vis)
    full, full_g = emu_frame
    rows = slice(row0 * th, (row0 + slab_rows) * th)
    if row0 < r.tiles_y:
        assert int((vis[1] >= 0).sum()) > 500
        assert torch.equal(out, full[:, rows])
    attrs = _attrs(frame)
    g = resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=16, tile_row_offset=row0, tile_h=th)
    got = _emu_resolve(emu, vis, attrs, y_offset=row0 * th)
    assert_resolve_close(got, g, vis[1] >= 0)
    if row0 < r.tiles_y:
        assert torch.equal(got, full_g[:, rows])


def _gbuf(frame):
    r, kw, sc, _, so, bins = frame
    vis = raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], tile_h=kw["tile_h"],
                                       tile_w=kw["tile_w"], tiles_x=r.tiles_x, tiles_y=r.tiles_y)
    attrs = resolve.pack_resolve_attrs(so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"],
                                       sc["face_tex"], sc["atlas"])
    return resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=16)


def _tiles(frame):
    r, kw = frame[0], frame[1]
    return dict(tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"])


def _emu_plan(emu, g, tiles, max_anisotropy=16):
    """The emulated plan kernel's (table, assign, residual_px) on G-buffer g."""
    t_total = tiles["tiles_x"] * tiles["tiles_y"]
    table = torch.full((t_total, 8, 128), -7, dtype=torch.int32)
    assign = torch.full((2,) + tuple(g.shape[1:]), -9.0)
    residual_px = torch.zeros((), dtype=torch.int32)
    scratch = sampler.plan_scratch(tiles["tile_h"], tiles["tile_w"], g.shape[1], g.shape[2], "cpu")
    err = emu.tr_plan(g.data_ptr(), tiles["tiles_x"], tiles["tiles_y"], tiles["tile_h"], tiles["tile_w"],
                      sampler.rc_for(tiles["tile_h"]), max_anisotropy, table.data_ptr(), assign.data_ptr(),
                      residual_px.data_ptr(), None if scratch is None else scratch.data_ptr(), None)
    assert err == 0
    return table, assign, int(residual_px)


def test_plan_kernel(emu, frame):
    g = _gbuf(frame)
    tiles = _tiles(frame)
    plan = sampler.plan_tiles_plain(g, max_anisotropy=16, **tiles)
    table, assign, residual_px = _emu_plan(emu, g, tiles)
    assert (plan["cls"] == sampler.CLS_WINDOWED).sum() >= 4
    assert torch.equal(table, plan["table"])
    assert torch.equal(assign, plan["assign"])
    assert residual_px == int(plan["residual_px"])


@pytest.mark.parametrize("n_tex,cols,cls,least_windows", [(24, 6, sampler.CLS_WINDOWED, 24),
                                                          (40, 10, sampler.CLS_RESIDUAL, 32)],
                         ids=["many_windows", "residual"])
def test_plan_kernel_many_textures(emu, n_tex, cols, cls, least_windows):
    """A tile that needs one window per texture: 24 of them fit the plan's
    32 slots (each greedy round is two block-wide minima, and the plan
    words of 24 slots are merged by the warps' atomics); 40 do not, and the
    tile goes residual with its 32 windows kept."""
    g = texture_grid_gbuf(n_tex, cols)
    tiles = dict(tiles_x=1, tiles_y=1, tile_h=32, tile_w=128)
    plan = sampler.plan_tiles_plain(g, max_anisotropy=16, **tiles)
    assert int(plan["cls"][0]) == cls and int(plan["n_used"][0]) >= least_windows
    assert (int(plan["residual_px"]) > 0) == (cls == sampler.CLS_RESIDUAL)
    assert int((plan["table"][0, 1:3, :32] != 0).sum()) >= least_windows
    table, assign, residual_px = _emu_plan(emu, g, tiles)
    assert torch.equal(table, plan["table"])
    assert torch.equal(assign, plan["assign"])
    assert residual_px == int(plan["residual_px"])


@pytest.mark.parametrize("planes,value", [((6,), "nan"), ((7,), "nan"), ((6, 7, 14, 15, 17), "nan"),
                                          ((6,), "inf"), ((20,), "inf"), ((23,), "-inf"), ((20, 21, 22, 23), "inf")],
                         ids=["nan_u", "nan_v", "nan_all", "inf_u", "inf_own_origin", "neg_inf_parent_origin",
                              "inf_origins"])
def test_plan_kernel_nan_under_a_matched_pixel(emu, planes, value):
    """A NaN or infinite u, v, derivative or page origin under one matched
    pixel: both versions make that tile residual with no window and no
    assignment; the tile beside it is planned as if nothing had happened.
    The reference defines nothing here (it converts the non-finite anchor
    to an integer), so this rule is the port's own and the case stands
    outside the comparison with the reference: it holds the kernel to the
    plain version, and both to the rule. An infinite origin gives an
    infinite anchor, which the fit test lets through (inf - inf is NaN)."""
    g = poisoned_gbuf(planes, value)
    tiles = dict(tiles_x=2, tiles_y=1, tile_h=32, tile_w=128)
    plan = sampler.plan_tiles_plain(g, max_anisotropy=16, **tiles)
    assert plan["cls"].tolist() == [sampler.CLS_RESIDUAL, sampler.CLS_WINDOWED]
    assert plan["n_used"].tolist()[0] == 0 and plan["n_used"].tolist()[1] >= 6
    assert bool((plan["assign"][:, :, :128] == -1).all())
    assert int(plan["residual_px"]) == int((g[16, :, :128] > 0).sum())
    table, assign, residual_px = _emu_plan(emu, g, tiles)
    assert torch.equal(table, plan["table"])
    assert torch.equal(assign, plan["assign"])
    assert residual_px == int(plan["residual_px"])


# Tile shapes past the kernels' 4096-px units, on tests/test_torch_memsafety.py's
# small orbit scene (the plain raster evaluates every pixel of a pair's
# tile): (frame size, tile_h, tile_w).
# The raster kernel cuts such a tile into sub-rectangles (raster.tile_subs)
# and the plan kernel goes over it in groups of 4096 px with its state in
# scratch (sampler.plan_scratch). 112x384 is 7 chunks of 16 rows over 11
# groups and 12 sub-rectangles, the last row of them 16 rows short; 8x1920
# is 4 sub-rectangles of 8x512, the last 384 columns wide; 64x128 at 130x49
# lies off the tile grid (one tile row and two columns of padding).
LARGE_TILES = {"64x128": ((256, 128), 64, 128), "16x1024": ((256, 128), 16, 1024),
               "112x384": ((256, 128), 112, 384), "8x1920": ((256, 128), 8, 1920),
               "64x128_off_grid": ((130, 49), 64, 128)}


@pytest.fixture(scope="module")
def small_scene():
    return build_orbit_scene(seed=2, **SMALL_SCENE)


@pytest.fixture(scope="module", params=list(LARGE_TILES))
def large_tiles(request, small_scene):
    """The small scene, camera 5, at a LARGE_TILES shape: (tiles, setup,
    bins, plain raster output, plain G-buffer, the Renderer's scene and
    camera position)."""
    (w, h), th, tw = LARGE_TILES[request.param]
    r = Renderer(small_scene, RendererConfig(width=w, height=h, tile_h=th, tile_w=tw), device="cpu")
    vp, cp = r.frame_uniforms(orbit_track(8)[5])
    sc = r.scene
    so = geometry.triangle_setup(geometry.transform_corners(sc["corner_world"], vp), None, sc["n_faces"], w, h)
    tiles = dict(tile_h=th, tile_w=tw, tiles_x=r.tiles_x, tiles_y=r.tiles_y)
    bins = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, r.tiles_y, tw, th)
    vis = raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], **tiles)
    attrs = resolve.pack_resolve_attrs(so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"],
                                       sc["face_tex"], sc["atlas"])
    g = resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=16)
    return tiles, so, bins, vis, g, sc, cp


def test_raster_kernel_large_tiles(emu, large_tiles):
    """Units of (tile, sub-rectangle, chunk): depth and face id equal the
    plain version's bit for bit."""
    tiles, so, bins, vis, _, _, _ = large_tiles
    _, _, nx, ny = raster.tile_subs(tiles["tile_h"], tiles["tile_w"])
    assert nx * ny > 1
    assert int((vis[1] >= 0).sum()) > 1000
    assert torch.equal(_emu_raster(emu, so, bins, tiles), vis)


def test_plan_kernel_large_tiles(emu, large_tiles):
    """The plan's groups of 4096 px: table, assignment and residual pixels
    equal the plain version's."""
    tiles, _, _, _, g, _, _ = large_tiles
    plan = sampler.plan_tiles_plain(g, max_anisotropy=16, **tiles)
    assert (plan["cls"] == sampler.CLS_WINDOWED).sum() >= 1
    table, assign, residual_px = _emu_plan(emu, g, tiles)
    assert torch.equal(table, plan["table"])
    assert torch.equal(assign, plan["assign"])
    assert residual_px == int(plan["residual_px"])


def test_sample_kernel_large_tiles(emu, large_tiles):
    """The sample kernel reads each pixel's tile class at any tile shape:
    within 1 LSB of the plain version, the clear color where unmatched."""
    tiles, _, _, _, g, sc, cp = large_tiles
    kw = RendererConfig()
    light = dict(light_direction=kw.light_direction, light_color=kw.light_color, ambient_amount=kw.ambient_amount,
                 specular_power=kw.specular_power, clear_color=kw.clear_color, blend="alpha")
    plan = sampler.plan_tiles_plain(g, max_anisotropy=16, **tiles)
    page = sc["atlas"]["page"]
    fb = sampler.sample_tiles_plain(g, page, plan, cp, max_anisotropy=16, **tiles, **light)
    out = _emu_sample(emu, g, page, plan, cp, tiles, light, 16)
    hp, wp = g.shape[1:]
    lsb = (present.encode_srgb_u8(out, wp, hp).int() - present.encode_srgb_u8(fb, wp, hp).int()).abs().max()
    assert int(lsb) <= 1
    assert torch.equal(out[:, g[16] == 0], fb[:, g[16] == 0])


@pytest.mark.parametrize("n_tex,cols,cls,least_windows", [(24, 6, sampler.CLS_WINDOWED, 24),
                                                          (40, 10, sampler.CLS_RESIDUAL, 32)],
                         ids=["many_windows", "residual"])
def test_plan_kernel_many_textures_large_tile(emu, n_tex, cols, cls, least_windows):
    """test_plan_kernel_many_textures' tiles, two of them stacked into one
    64x128 tile (the large path's groups): 24 windows fit, 40 do not."""
    g = torch.cat([texture_grid_gbuf(n_tex, cols), texture_grid_gbuf(n_tex, cols, seed=12)], dim=1)
    tiles = dict(tiles_x=1, tiles_y=1, tile_h=64, tile_w=128)
    plan = sampler.plan_tiles_plain(g, max_anisotropy=16, **tiles)
    assert int(plan["cls"][0]) == cls and int(plan["n_used"][0]) >= least_windows
    table, assign, residual_px = _emu_plan(emu, g, tiles)
    assert torch.equal(table, plan["table"])
    assert torch.equal(assign, plan["assign"])
    assert residual_px == int(plan["residual_px"])


def _emu_sample(emu, g, page, plan, cp, tiles, light, max_anisotropy):
    out = torch.full((4,) + tuple(g.shape[1:]), -3.0)
    params = (ctypes.c_float * sampler.N_PARAMS)(*sampler.shade_params(**light))
    err = emu.tr_sample(g.data_ptr(), page.data_ptr(), page.shape[2], plan["table"].data_ptr(), cp.data_ptr(),
                        tiles["tiles_x"], tiles["tiles_y"], tiles["tile_h"], tiles["tile_w"], max_anisotropy,
                        ctypes.addressof(params), out.data_ptr(), None)
    assert err == 0
    return out


@pytest.mark.parametrize("blend,residual,max_anisotropy",
                         [("alpha", False, 16), ("opaque", False, 16), ("alpha", True, 16), ("alpha", False, 1)],
                         ids=["alpha", "opaque", "residual", "isotropic"])
def test_sample_kernel(emu, frame, blend, residual, max_anisotropy):
    """The kernel on the channel-interleaved page against the plain version
    on its (4, PH, PW) view; with every covered tile marked residual the
    kernel's frame must not change (the plan decides nothing but the
    empty-tile skip); at max_anisotropy 1 every pixel takes one probe."""
    r, kw, sc, cp, _, _ = frame
    g = _gbuf(frame)
    tiles = _tiles(frame)
    plan = sampler.plan_tiles(g, max_anisotropy=max_anisotropy, **tiles)
    light = dict(light_direction=kw["light_direction"], light_color=kw["light_color"],
                 ambient_amount=kw["ambient_amount"], specular_power=kw["specular_power"],
                 clear_color=kw["clear_color"], blend=blend)
    page = sc["atlas"]["page"]
    sampler._check_page(page)
    fb = sampler.sample_tiles_plain(g, page, plan, cp, max_anisotropy=max_anisotropy, **tiles, **light)
    out = _emu_sample(emu, g, page, plan, cp, tiles, light, max_anisotropy)
    if residual:
        table = plan["table"].clone()
        table[:, 0, 0] = torch.where(table[:, 0, 0] == sampler.CLS_WINDOWED, sampler.CLS_RESIDUAL, table[:, 0, 0])
        assert not torch.equal(table, plan["table"])
        assert torch.equal(_emu_sample(emu, g, page, dict(plan, table=table), cp, tiles, light, max_anisotropy), out)
    w, h = kw["width"], kw["height"]
    lsb = (present.encode_srgb_u8(out, w, h).int() - present.encode_srgb_u8(fb, w, h).int()).abs().max()
    assert int(lsb) <= 1
    assert torch.equal(out[:, g[16] == 0], fb[:, g[16] == 0])


@pytest.mark.parametrize(
    "plane,block_h,block_w,height,width",
    [(16, 32, 128, 64, 384), (0, 32, 128, 64, 384), (16, 32, 384, 64, 384), (3, 24, 100, 64, 384),
     (16, 32, 128, 64, 381), (5, 7, 3, 16, 24), (1, 5, 2, 15, 23), (2, 9, 10, 20, 24)],
    ids=["tile_grid", "one_plane", "row_band", "ragged", "odd_width", "narrow_blocks", "unaligned_plane",
         "mixed_rects"],
)
def test_plane_scale_kernel(emu, plane, block_h, block_w, height, width):
    """The float4 rectangles, the scalar head and tail (rows not on a
    16-byte boundary: odd widths, blocks narrower than 4), the all-scalar
    rows of a plane whose offset is not a multiple of 4 floats (15 x 23),
    and a launch with both kinds of rectangle (10 columns, the last 4); at the
    default block size and at sizes that give a row fewer threads than
    moves (32), a team that does not fill whole warps (100) and the most
    (1024)."""
    g = torch.from_numpy(np.random.default_rng(4).uniform(-2, 2, (24, height, width)).astype(np.float32))
    src = g[16:17].clone() if plane == 0 else g
    want = probes.plane_scale_plain(src, plane, block_h=block_h, block_w=block_w)
    for threads in (0, 32, 100, 1024):
        out = torch.full_like(want, -1.0)
        err = emu.tr_plane_scale(src.data_ptr(), plane, height, width, block_h, block_w, threads, out.data_ptr(),
                                 None)
        assert err == 0
        assert torch.equal(out, want), f"{threads} threads"
    assert torch.equal(out[0], 2.0 * g[16] if plane in (0, 16) else 2.0 * g[plane])
    for threads in (16, 2048):
        assert emu.tr_plane_scale(src.data_ptr(), plane, height, width, block_h, block_w, threads, out.data_ptr(),
                                  None) != 0


@pytest.mark.parametrize(
    "rows,n,offset",
    [(4096, 1000, 0), (4095, 999, 0), (33, 130, 1), (1, 5, 0), (64, 32, 0), (7, 0, 0)],
    ids=["tool_table", "odd_rows_ragged_n", "unaligned_idx", "one_row", "one_warp", "no_index"],
)
def test_vmem_take_kernel(emu, rows, n, offset):
    """Bit for bit the plain version: the left-to-right sum carried across
    the four lanes of a row, the last warp and block partly past n, rows
    outside [0, rows) clamped, and an index array that starts off the
    16-byte grid."""
    rng = np.random.default_rng(rows + n)
    table = torch.from_numpy(rng.uniform(-1, 1, (rows, probes.TAKE_WIDTH)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-3, rows + 3, n + offset).astype(np.int32))[offset:]
    out = torch.full((n,), -7.0)
    assert emu.tr_vmem_take(table.data_ptr(), rows, idx.data_ptr(), n, out.data_ptr(), None) == 0
    assert torch.equal(out, probes.vmem_take_plain(table, idx))
    assert emu.tr_vmem_take(table.data_ptr() + 4, rows, idx.data_ptr(), n, out.data_ptr(), None) != 0
    assert emu.tr_vmem_take(table.data_ptr(), 0, idx.data_ptr(), n, out.data_ptr(), None) != 0
