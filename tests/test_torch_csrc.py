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
the frame. tests/test_torch_csrc_tiles.py runs raster, plan and sample at
tiles past 4096 px.

The shade kernels (csrc/shade.cu: tr_shade_gbuffer, tr_shade_deferred)
run on the small scene at 128x64 against shade_gbuffer_plain and
shade_deferred_plain: the four texel formats (float32, float16, bfloat16,
srgb8) at max_anisotropy 16, float16 and srgb8 at 1, alpha and opaque
blend, background pixels, a slab's y_offset, mip sizes of 0 and rows
clamped into the table (assert_shade_close: bit for bit but where torch's
CPU pow or log2 rounds unlike glibc's, then within 1 LSB), the deferred
kernel equal to the gather kernel on the emulated resolve kernel's
G-buffer bit for bit, and rows off their load grid refused (face rows off
the 16-byte grid too). The kernels' wide row loads (six two-texel loads
and one texel, their order by the row's parity; a load off its alignment
is an error of the launch here, as the card faults) also run on warp
shapes (WARP_SHAPES: every lane at 16 probes, one covered lane a warp,
warps with none, rows clamped to the table's ends) in the four formats,
and the deferred kernel's 16-byte face-row loads on face ids with one
covered lane a warp, warps with none and rows clamped to the last row.
Both kernels read each face's row in two parts, the frame's setup row and
the scene's table (resolve.scene_table, shade.scene_table): on a slab, a
scene without pages, face ids on the padded rows and past the last row,
and the last row of both, they give the plain versions' bits on the
packed tables (but the last bit of log2 and sqrt), and either table off
the 16-byte grid is refused.

chip_smoke.py's count of the shade kernels' L1 requests
(shade_warp_lines) is held to a count by hand on a small G-buffer.

The frame trace's mark kernel (csrc/trace.cu) fills a frame's slot of its
ring with the sequence number, monotonic times and the counters, and the
ring wraps; each render kernel stamps its start and end marks when given
their words, its output unchanged (the emulation's %globaltimer is the
host's monotonic clock).

The binning kernels (csrc/bin.cu tr_bin) run through geometry.bin_pairs and
bin_triangles themselves, the emulated library standing in for the card's
(emu_bin), against the plain binners: offsets, counts and overflow
exactly, the pairs on the live prefix (bin_triangles' whole buffer), one
launch a call; on tests/test_torch_geometry.py's random faces, a slab of
them, the orbit frame, no faces, no valid face, every face huge, faces of
more pairs than a lane writes, y-buckets clamped past 8,192 rows, 8,100
tiles (the tile sort's two passes), the scan contract with room and with
half the pairs' room; and a call on two devices raises.

The setup kernel (csrc/setup.cu tr_setup) runs through geometry.setup_faces
the same way, against transform_corners and triangle_setup: all five
outputs bit for bit (NaN where the plain version has NaN) on
tests/test_torch_geometry.py's faces and at 1, 255, 257 and 2,051 faces,
with padding past n_faces and NaN and infinite corners, and on faces where
a rounding decides (a fused multiply-add in the cross products or
round-half-away in the anchor would show); corners off the
16-byte grid are refused; and render_frame with every kernel emulated
renders the same frames as inside plain_kernels(), one setup launch a
frame, on the window path and on the deferred path (its one face table,
the shade table).

The encode kernel (csrc/encode.cu tr_encode) runs through
present.encode_srgb_u8 the same way, against encode_srgb_u8_plain, one
launch a call (tests/test_torch_memsafety.py's ENCODE_CASES): random frames
with values below 0 and above 1, a frame on the tile grid with padded rows,
a width off the 4-pixel grid, a slab's crop (fewer rows than its planes),
rows off the 16-byte grid, and the values on which a rounding decides (the
half-LSB ties of x * 255 in both segments of the transfer curve and in
alpha, the threshold 0.0031308 and its neighbours, NaN, the infinities,
-0.0, 0, 1): bit for bit against the plain arithmetic with the host's powf
in place of torch's CPU pow, which rounds otherwise at about 1% of values
(assert_encode_equal), so within 1 LSB of the plain version. The wrapper refuses planes that are
not (4, Hp, Wp) contiguous f32 or a crop past them, CPU tensors take the
plain version, and a slab's render_frame with every kernel emulated equals
its plain frame, one encode launch a frame and a slab.

Time on one worker: about 71 s (the shade cases about a fifth of it: the
plain gather runs 16 probes over every pixel; the warp-shape cases about
5 s together, the request counts about 2 s; the binning cases about 27 s,
their 1,024-thread blocks emulated, the two-pass ones the longest); the
setup cases add about 11 s, 9 of them the two emulated frames (111 s in
all on a loaded host, the emulated library's build 21 s of it); the split
face-row cases about 5 s each, the emulated deferred frames about 15 s; the
encode cases about 2 s, 1.3 s of it the emulated slab frame.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.device.textures import TEXTURE_DTYPES, texels_tensor
from tpurast_torch.kernels import _build, geometry, present, probes, raster, resolve, sampler, shade
from tpurast_torch.renderer import Renderer
from test_torch_memsafety import (ENCODE_CASES, SCENE as SMALL_SCENE, SETUP_CASES, SPLIT_CASES, assert_encode_equal,
                                  assert_resolve_bits, assert_resolve_close, assert_same_bits, assert_shade_close,
                                  bin_boxes, encode_inputs, encode_specials, poisoned_gbuf, setup_inputs,
                                  split_rows, texture_grid_gbuf)
from test_torch_raster import ADVERSARIAL, A_TILES_X, A_TILES_Y, AH, AW, adversarial_clip
from test_torch_scene import numpy_bc_decoders  # noqa: F401  (module-wide autouse)

def emu_library(tmp_path_factory) -> ctypes.CDLL:
    """csrc/*.cu built for the host emulation with g++, one build per
    source text a test run: the library lands in the directory all of the
    run's pytest workers share, named by a hash of the sources, under a
    file lock, so the modules that load it (this one,
    tests/test_torch_csrc_tiles.py) build it once between them."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulated kernels")
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    srcs = sorted(p for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h"))
    digest = hashlib.sha256(b"".join(p.name.encode() + p.read_bytes() for p in srcs)).hexdigest()[:16]
    out = shared / f"libtpurast_torch_emu_{digest}.so"
    with open(shared / "emu.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
                   "-DTR_HOST_EMU", "-x", "c++", *(str(p) for p in srcs if p.suffix == ".cu"), "-o", str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr
            os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    for name, n_in in _build.COUNTS.items():
        getattr(lib, name).argtypes = [ctypes.c_int] * n_in
        getattr(lib, name).restype = ctypes.c_longlong
    return lib


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emu_library(tmp_path_factory)


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


def _emu_raster(emu, so, bins, args, clear_depth=0.0, row0=0, marks=(None, None)):
    """The emulated raster kernel's (2, Hp, Wp) output; marks: the
    addresses of the frame trace's start and end words, or None."""
    slots = bins["pair_faces"].numel()
    keys, work, out = raster.kernel_buffers(args["tile_h"], args["tile_w"], args["tiles_x"], args["tiles_y"], slots,
                                            "cpu")
    out.fill_(-7.0)
    err = emu.tr_raster(so["setup"].data_ptr(), so["aabb"].data_ptr(), bins["pair_faces"].data_ptr(),
                        bins["offsets"].data_ptr(), slots, args["tiles_x"], args["tiles_y"], args["tile_h"],
                        args["tile_w"], row0, clear_depth, keys.data_ptr(), work.data_ptr(), work.numel(),
                        out.data_ptr(), *marks, None)
    assert err == 0
    return out


def _emu_resolve(emu, vis, rows, y_offset=0, max_anisotropy=16, marks=(None, None)):
    """The emulated resolve kernel's G-buffer from rows: the (F, 24) setup
    rows and the (F, 80) per-scene table (resolve.scene_table)."""
    setup, table = rows
    out = torch.full((resolve.A_OUT,) + tuple(vis.shape[1:]), -5.0)
    err = emu.tr_resolve(vis.data_ptr(), setup.data_ptr(), table.data_ptr(), setup.shape[0], vis.shape[1],
                         vis.shape[2], y_offset, max_anisotropy, out.data_ptr(), *marks, None)
    assert err == 0
    return out


def _rows(frame):
    """The frame's setup rows and the scene's resolve table, as the kernel
    takes them."""
    sc, so = frame[2], frame[4]
    return so["setup"], sc["resolve_table"]


def _attrs(frame):
    """The packed attribute table the plain version takes: the same two
    parts put together."""
    return resolve.join_attrs(*_rows(frame))


def test_resolve_kernel(emu, frame):
    r, kw, sc, _, so, bins = frame
    vis = raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], tile_h=kw["tile_h"],
                                       tile_w=kw["tile_w"], tiles_x=r.tiles_x, tiles_y=r.tiles_y)
    attrs = _attrs(frame)
    g = resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=16)
    assert_resolve_close(_emu_resolve(emu, vis, _rows(frame)), g, vis[1] >= 0)


@pytest.fixture(scope="module")
def emu_frame(emu, frame):
    """The emulated raster and resolve kernels' whole frame."""
    r, kw, _, _, so, bins = frame
    vis = _emu_raster(emu, so, bins, dict(tile_h=kw["tile_h"], tile_w=kw["tile_w"], tiles_x=r.tiles_x,
                                          tiles_y=r.tiles_y))
    return vis, _emu_resolve(emu, vis, _rows(frame))


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
    got = _emu_resolve(emu, vis, _rows(frame), y_offset=row0 * th)
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


def _emu_sample(emu, g, page, plan, cp, tiles, light, max_anisotropy, marks=(None, None)):
    out = torch.full((4,) + tuple(g.shape[1:]), -3.0)
    params = (ctypes.c_float * shade.N_PARAMS)(*shade.shade_params(**light))
    err = emu.tr_sample(g.data_ptr(), page.data_ptr(), page.shape[2], plan["table"].data_ptr(), cp.data_ptr(),
                        tiles["tiles_x"], tiles["tiles_y"], tiles["tile_h"], tiles["tile_w"], max_anisotropy,
                        ctypes.addressof(params), out.data_ptr(), *marks, None)
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


@pytest.fixture(scope="module")
def small_scene():
    return build_orbit_scene(seed=2, **SMALL_SCENE)


# shade.cu's kernels on the small scene at SHADE_SIZE (camera 2 of
# orbit_track(8)): the plain gather at max_anisotropy 16 runs every probe
# over every pixel, so the frame is kept small.
SHADE_SIZE = (128, 64)


@pytest.fixture(scope="module")
def shade_frame(small_scene):
    """Face ids, attribute and shade-row tables, the atlas rows in each
    texel dtype, camera position, light, page and tiles of the small
    scene's frame."""
    w, h = SHADE_SIZE
    r = Renderer(small_scene, RendererConfig(width=w, height=h), device="cpu")
    kw, sc = r._frame_kwargs, r.scene
    vp, cp = r.frame_uniforms(orbit_track(8)[2])
    so = geometry.triangle_setup(geometry.transform_corners(sc["corner_world"], vp), None, sc["n_faces"], w, h)
    bins = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"])
    vis = raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"],
                                       tile_h=kw["tile_h"], tile_w=kw["tile_w"], tiles_x=r.tiles_x,
                                       tiles_y=r.tiles_y)
    corners = (so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"], sc["face_tex"], sc["atlas"])
    light = dict(light_direction=kw["light_direction"], light_color=kw["light_color"],
                 ambient_amount=kw["ambient_amount"], specular_power=kw["specular_power"],
                 clear_color=kw["clear_color"])
    return dict(vis=vis, fid=vis[1].to(torch.int32), attrs=resolve.pack_resolve_attrs(*corners),
                resolve_rows=(so["setup"], resolve.scene_table(*corners[1:])), setup=so["setup"], sc=sc,
                rows=shade.pack_shade_rows(*corners), cp=cp, light=light, page=sc["atlas"]["page"],
                tiles=dict(tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"]),
                texels={dt: texels_tensor(small_scene.atlas.texels, dt, "cpu") for dt in TEXTURE_DTYPES})


def _texel_format(dtype: str) -> str:
    return "srgb8" if dtype == "srgb8" else "float"


def _emu_shade(emu, kernel, texels, texel_format, cp, light, max_anisotropy, *, gbuf=None, fid=None, rows=None,
               y_offset=0, marks=(None, None)):
    """The emulated tr_shade_gbuffer (gbuf) or tr_shade_deferred (fid,
    rows) launch's (4, H, W) framebuffer, through the wrapper's row check.
    The deferred kernel takes fid as the raster's f32 plane and rows as
    the (F, 24) setup rows and the (F, 80) per-scene table: a pair of
    them, or a (F, 104) pack_shade_rows table cut into the two."""
    code, lut = shade._check_rows(texels, texel_format, shade.srgb_table("cpu"))
    lut_ptr = None if lut is None else lut.data_ptr()
    params = (ctypes.c_float * shade.N_PARAMS)(*shade.shade_params(**light))
    h, w = (gbuf.shape[1:] if kernel == "gather" else fid.shape)
    out = torch.full((4, h, w), -3.0)
    if kernel == "gather":
        err = emu.tr_shade_gbuffer(gbuf.data_ptr(), texels.data_ptr(), texels.shape[0], code, lut_ptr, cp.data_ptr(),
                                   h, w, max_anisotropy, ctypes.addressof(params), out.data_ptr(), *marks, None)
    else:
        fid = fid.float()
        setup, table = rows if isinstance(rows, tuple) else (rows[:, :24].contiguous(), rows[:, 24:].contiguous())
        shade._check_face_rows(setup, table)
        err = emu.tr_shade_deferred(fid.data_ptr(), setup.data_ptr(), table.data_ptr(), setup.shape[0],
                                    texels.data_ptr(), texels.shape[0], code, lut_ptr, cp.data_ptr(), h, w, y_offset,
                                    max_anisotropy, ctypes.addressof(params), out.data_ptr(), *marks, None)
    assert err == 0
    return out


# (texel dtype, max_anisotropy, blend): the four texel formats at 16
# probes, float16 and srgb8 at 1, float16 opaque.
SHADE_CASES = ([(dt, 16, "alpha") for dt in TEXTURE_DTYPES] + [("float16", 1, "alpha"), ("srgb8", 1, "alpha"),
                                                               ("float16", 16, "opaque")])


@pytest.mark.parametrize("dtype,max_anisotropy,blend", SHADE_CASES,
                         ids=[f"{dt}_aniso{ma}_{b}" for dt, ma, b in SHADE_CASES])
def test_shade_kernels(emu, shade_frame, dtype, max_anisotropy, blend):
    """tr_shade_gbuffer on the plain G-buffer and tr_shade_deferred on the
    face ids against shade_gbuffer_plain / shade_deferred_plain
    (assert_shade_close; at this frame 0-3 pixels differ in f32 and none
    by 1 LSB), background pixels included; and the deferred kernel equal
    bit for bit to the gather kernel on the emulated resolve kernel's
    G-buffer, as deferred equals forward + gather on the card."""
    f = shade_frame
    tex, fmt = f["texels"][dtype], _texel_format(dtype)
    light = dict(f["light"], blend=blend)
    vis, cp, covered = f["vis"], f["cp"], f["fid"] >= 0
    assert int(covered.sum()) > 1000 and int((~covered).sum()) > 1000
    g = resolve.resolve_gbuffer_plain(vis, f["attrs"], max_anisotropy=max_anisotropy)
    want = shade.shade_gbuffer_plain(g, tex, cp, max_anisotropy=max_anisotropy, texel_format=fmt, **light)
    out = _emu_shade(emu, "gather", tex, fmt, cp, light, max_anisotropy, gbuf=g)
    assert_shade_close(out, want, covered)
    want = shade.shade_deferred_plain(f["fid"], f["rows"], tex, cp, max_anisotropy=max_anisotropy,
                                      texel_format=fmt, **light)
    deferred = _emu_shade(emu, "deferred", tex, fmt, cp, light, max_anisotropy, fid=f["fid"], rows=f["rows"])
    assert_shade_close(deferred, want, covered)
    g_emu = _emu_resolve(emu, vis, f["resolve_rows"], max_anisotropy=max_anisotropy)
    assert torch.equal(deferred, _emu_shade(emu, "gather", tex, fmt, cp, light, max_anisotropy, gbuf=g_emu))


def test_shade_deferred_kernel_on_a_slab(emu, shade_frame):
    """The frame's lower 32 rows as a slab (y_offset 32): equal to the
    emulated whole frame's rows bit for bit and close to the plain slab."""
    f = shade_frame
    tex, light = f["texels"]["float16"], dict(f["light"], blend="alpha")
    full = _emu_shade(emu, "deferred", tex, "float", f["cp"], light, 16, fid=f["fid"], rows=f["rows"])
    fid = f["fid"][32:].contiguous()
    slab = _emu_shade(emu, "deferred", tex, "float", f["cp"], light, 16, fid=fid, rows=f["rows"], y_offset=32)
    assert int((fid >= 0).sum()) > 500
    assert torch.equal(slab, full[:, 32:])
    want = shade.shade_deferred_plain(fid, f["rows"], tex, f["cp"], max_anisotropy=16, y_offset=32, **light)
    assert_shade_close(slab, want, fid >= 0)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_resolve_and_deferred_kernels_from_split_rows(emu, shade_frame, case):
    """The resolve and deferred kernels read each face's row from the
    frame's setup rows and the scene's table (split_rows' cases: a slab,
    a scene without pages, face ids on the padded rows and past the last
    row, the last row of both allocations, each a tensor of its own): the
    same bits as the plain versions on pack_resolve_attrs and
    pack_shade_rows at anisotropy 16, NaN where they have NaN; of the
    G-buffer, the mip fraction's and the probe span's last bits are log2's
    and sqrt's (assert_resolve_bits).
    The deferred frame also equals the emulated gather kernel's on that
    G-buffer bit for bit."""
    f = shade_frame
    c = split_rows(case, f["vis"], f["setup"], f["sc"])
    vis, plain_vis, y0 = c["vis"], c["plain_vis"], c["y_offset"]
    fid = vis[1]
    assert int((plain_vis[1] >= 0).sum()) > 500
    if case == "padded_faces":
        assert int((fid >= f["sc"]["n_faces"]).sum()) > 100 and int((fid >= c["setup"].shape[0]).sum()) > 5
    th = 32
    g = _emu_resolve(emu, vis, (c["setup"].clone(), c["resolve_table"].clone()), y_offset=y0)
    want = resolve.resolve_gbuffer_plain(plain_vis, c["attrs"], max_anisotropy=16, tile_row_offset=y0 // th,
                                         tile_h=th)
    assert_resolve_bits(g, want, f"resolve, {case}")
    tex, light = f["texels"]["float16"], dict(f["light"], blend="alpha")
    got = _emu_shade(emu, "deferred", tex, "float", f["cp"], light, 16, fid=fid,
                     rows=(c["setup"].clone(), c["shade_table"].clone()), y_offset=y0)
    want = shade.shade_deferred_plain(plain_vis[1].to(torch.int32), c["shade_rows"], tex, f["cp"], max_anisotropy=16,
                                      y_offset=y0, **light)
    assert_same_bits(got, want, f"deferred, {case}")
    gathered = _emu_shade(emu, "gather", tex, "float", f["cp"], light, 16, gbuf=g)
    assert torch.equal(got, gathered)


@pytest.mark.parametrize("dtype", ["float32", "srgb8"])
def test_shade_kernels_width_0_and_rows_outside_the_table(emu, shade_frame, dtype):
    """Textures the plain versions survive only by their two guards: a mip
    width and height of 0 (the modulus taken at 1) and atlas offsets past
    either end of the table (the row index clamped to row 0 or the last
    row), on a third of the covered pixels each (gather: the G-buffer's
    planes 8-12; deferred: faces' texture info in the shade rows)."""
    f = shade_frame
    tex, fmt = f["texels"][dtype], _texel_format(dtype)
    light, cp, covered = dict(f["light"], blend="alpha"), f["cp"], f["fid"] >= 0
    n = tex.shape[0]
    g = resolve.resolve_gbuffer_plain(f["vis"], f["attrs"], max_anisotropy=16)
    third = torch.remainder(torch.arange(g[0].numel()).view(g.shape[1:]), 3)
    g[9:13, third == 0] = 0.0
    g[8, third == 1] = float(n // 256 + 8)
    g[8, third == 2] = -8.0
    want = shade.shade_gbuffer_plain(g, tex, cp, max_anisotropy=16, texel_format=fmt, **light)
    assert_shade_close(_emu_shade(emu, "gather", tex, fmt, cp, light, 16, gbuf=g), want, covered)

    rows = f["rows"].clone()
    info = rows[:, shade.ROW_TEXINFO:shade.ROW_TEXINFO + shade.TEX_ROW_WIDTH].view(torch.int32)
    face = torch.remainder(torch.arange(rows.shape[0]), 3)
    info[face == 0, 16:48] = 0
    info[face == 1, 0:16] += n
    info[face == 2, 0:16] -= n
    want = shade.shade_deferred_plain(f["fid"], rows, tex, cp, max_anisotropy=16, texel_format=fmt, **light)
    assert_shade_close(_emu_shade(emu, "deferred", tex, fmt, cp, light, 16, fid=f["fid"], rows=rows), want, covered)


def test_shade_deferred_kernel_refuses_misaligned_face_rows(emu, shade_frame):
    """The deferred kernel copies its face rows in 16-byte chunks: setup
    rows or a per-scene table off that grid are refused
    (cudaErrorInvalidValue) before the launch, and the wrapper's check
    (shade._check_face_rows) raises on them."""
    f = shade_frame
    tex, rows, fid = f["texels"]["float16"], f["rows"], f["fid"].float()
    setup, table = rows[:, :24].contiguous(), rows[:, 24:].contiguous()
    params = (ctypes.c_float * shade.N_PARAMS)(*shade.shade_params(**dict(f["light"], blend="alpha")))
    out = torch.empty((4,) + tuple(fid.shape))

    def off_grid(t):
        shifted = torch.empty(t.numel() + 4)[1:t.numel() + 1].view(t.shape)
        return shifted.copy_(t)

    for pair in ((off_grid(setup), table), (setup, off_grid(table))):
        err = emu.tr_shade_deferred(fid.data_ptr(), pair[0].data_ptr(), pair[1].data_ptr(), rows.shape[0],
                                    tex.data_ptr(), tex.shape[0], 1, None, f["cp"].data_ptr(), fid.shape[0],
                                    fid.shape[1], 0, 16, ctypes.addressof(params), out.data_ptr(), None, None, None)
        assert (pair[0].data_ptr() % 16 == 4 or pair[1].data_ptr() % 16 == 4) and err == 1
        with pytest.raises(ValueError, match="16-byte"):
            shade._check_face_rows(*pair)
    shade._check_face_rows(setup, table)
    with pytest.raises(ValueError, match="table"):
        shade._check_face_rows(setup, table[:-1].contiguous())


# Warp shapes of the shade kernels' probe loops, on a synthetic 128x8
# G-buffer (32 warps of 32 pixels): every pixel covered at 16 probes; one
# covered lane a warp at 16 probes; every other warp without a covered
# lane, the rest at random counts 1-16; random counts with the atlas
# offsets of a third of the pixels past the table's end (their rows clamp
# to its last row) and a third below it (row 0). The probes' rows fall on
# both parities, so both orders of the wide row loads run.
WARP_SHAPES = ("every_lane_16_probes", "single_lane", "no_lane", "last_row")


def _warp_shape_gbuf(shape: str, n_rows: int, seed: int = 5) -> torch.Tensor:
    """(18, 8, 128) G-buffer of WARP_SHAPES' shape: own mip 64x64 at offset
    0, parent 32x32, probe counts set through the major axis (ext = |maj_du|
    * 64 * span lands just below the count)."""
    rng = np.random.default_rng(seed)
    h, w = 8, 128
    g = torch.from_numpy(rng.random((18, h, w), dtype=np.float32))
    g[3:6] = g[3:6] * 2.0 - 1.0
    g[8] = 0.0
    g[9:11] = 64.0
    g[11:13] = 32.0
    g[17] = 0.9
    lane = torch.arange(h * w).view(h, w) % 32
    warp = torch.arange(h * w).view(h, w) // 32
    counts = torch.from_numpy(rng.integers(1, 17, (h, w))).float()
    covered = torch.ones((h, w), dtype=torch.bool)
    if shape == "every_lane_16_probes":
        counts[:] = 16.0
    elif shape == "single_lane":
        covered = lane == (warp * 7) % 32
        counts[:] = 16.0
    elif shape == "no_lane":
        covered = warp % 2 == 1
    else:
        third = torch.remainder(torch.arange(h * w).view(h, w), 3)
        g[8, third == 1] = float(n_rows // 256 + 8)
        g[8, third == 2] = -8.0
    g[14] = (counts - 0.5) / (64.0 * 0.9) * torch.where(lane % 2 == 0, 1.0, -1.0)
    g[15] = 0.1 / 64.0
    g[16] = covered.float()
    return g


@pytest.mark.parametrize("dtype", TEXTURE_DTYPES)
@pytest.mark.parametrize("shape", WARP_SHAPES)
def test_shade_gather_kernel_warp_shapes(emu, shade_frame, shape, dtype):
    """The emulated tr_shade_gbuffer on WARP_SHAPES' G-buffers, in each
    texel format, against shade_gbuffer_plain (assert_shade_close): the
    wide row loads and each lane's in-order sum hold where every lane runs
    16 probes, where one lane runs all of a warp's, where a warp has none
    and lanes with few probes run beside lanes with many, and on rows
    clamped to the table's ends (the last row, even or odd, read to its
    end and no further). About 0.5 s each."""
    f = shade_frame
    tex, fmt = f["texels"][dtype], _texel_format(dtype)
    light = dict(f["light"], blend="alpha")
    g = _warp_shape_gbuf(shape, tex.shape[0])
    covered = g[16] > 0
    npx = shade.probe_count(g[17], g[14], g[15], g[9], g[10], 16)
    if shape != "last_row":
        assert torch.equal(npx[covered], torch.full_like(npx[covered], 16.0)) or shape == "no_lane"
    per_warp = covered.view(-1, 32).sum(dim=1)
    if shape == "single_lane":
        assert torch.equal(per_warp, torch.ones_like(per_warp))
    if shape == "no_lane":
        assert int((per_warp == 0).sum()) == 16 and int((per_warp == 32).sum()) == 16
    want = shade.shade_gbuffer_plain(g, tex, f["cp"], max_anisotropy=16, texel_format=fmt, **light)
    assert_shade_close(_emu_shade(emu, "gather", tex, fmt, f["cp"], light, 16, gbuf=g), want, covered)


def _chip_smoke():
    """chip_smoke.py as a module (it needs no card to import)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "float16", "srgb8"])
def test_chip_smoke_counts_the_shade_kernels_l1_requests(monkeypatch, dtype):
    """chip_smoke.py::shade_warp_lines against a count by hand on the
    "last_row" warp shape with (u, v) spread over the texture: per warp of
    32 pixels and probe index, the distinct 128-byte lines of each texel
    load (a load a texel) and of each of csrc/shade.cu's wide loads (by the
    row's parity), and the face rows' loads per distinct face of a warp.
    About 1 s each."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "sm_clock", lambda: (132, 1.98e9, "test"))
    n_rows = 9001
    tex = torch.zeros((n_rows, 52), dtype=getattr(torch, dtype) if dtype != "srgb8" else torch.uint8)
    g = _warp_shape_gbuf("last_row", n_rows)
    g[6:8] = torch.from_numpy(np.random.default_rng(3).random((2, 8, 128), dtype=np.float32)) * 3
    fid = torch.where(g[16] > 0, torch.arange(8 * 128, dtype=torch.int32).view(8, 128) // 5, -1)
    got = cs.shade_warp_lines("deferred", g, fid, tex, 16)
    chunk = 52 * tex.element_size() // 13
    per_texel, wide = set(), set()
    for p, i, r in zip(*(t.tolist() for t in cs.shade_items(g, n_rows, 16))):
        for k in range(13):
            per_texel.add((p // 32, i, k, (r * 13 + k) * chunk // 128))
        offs = ([16 * k for k in range(13)] if chunk == 16 else
                [(r & 1) * chunk + 2 * chunk * j for j in range(6)] + [(1 - (r & 1)) * 12 * chunk])
        for j, off in enumerate(offs):
            wide.add((p // 32, i, j, (r * 13 * chunk + off) // 128))
    faces = {(p // 32, f) for p, f in enumerate(fid.reshape(-1).tolist()) if f >= 0}
    assert (got["texel_lines"], got["lines"]) == (len(per_texel), len(wide))
    assert (got["field_face_lines"], got["face_lines"]) == (43 * len(faces), 18 * len(faces))
    assert got["lines"] < got["texel_lines"] or dtype == "float32"


# The deferred kernel's warp shapes on the shade frame's face ids: one
# covered lane kept a warp; every other warp emptied; every face's atlas
# offsets moved to the table's last row (rows past it clamp there).
DEFERRED_WARP_SHAPES = ("single_lane", "no_lane", "last_row")


@pytest.mark.parametrize("shape", DEFERRED_WARP_SHAPES)
def test_shade_deferred_kernel_warp_shapes(emu, shade_frame, shape):
    """The emulated tr_shade_deferred at anisotropy 16 on float16 rows with
    DEFERRED_WARP_SHAPES' face ids and rows, against shade_deferred_plain.
    About 1 s each."""
    f = shade_frame
    tex, light = f["texels"]["float16"], dict(f["light"], blend="alpha")
    fid, rows = f["fid"].clone(), f["rows"]
    p = torch.arange(fid.numel()).view(fid.shape)
    if shape == "single_lane":
        fid[(p % 32) != 9] = -1
    elif shape == "no_lane":
        fid[(p // 32) % 2 == 0] = -1
    else:
        rows = rows.clone()
        rows[:, shade.ROW_TEXINFO:shade.ROW_TEXINFO + 16].view(torch.int32).fill_(tex.shape[0] - 1)
    covered = fid >= 0
    assert int(covered.sum()) > 30
    want = shade.shade_deferred_plain(fid, rows, tex, f["cp"], max_anisotropy=16, **light)
    assert_shade_close(_emu_shade(emu, "deferred", tex, "float", f["cp"], light, 16, fid=fid, rows=rows), want,
                       covered)


def test_shade_kernels_refuse_misaligned_rows(emu, shade_frame):
    """Each format's rows load at their own width (16, 8 or 4 bytes): rows
    that start off that grid are refused (cudaErrorInvalidValue) before the
    launch. A vector load off its alignment inside a launch, a fault on the
    card, is an error of the launch under the emulation: the sample kernel
    handed a page 2 bytes off its 8-byte grid returns
    cudaErrorMisalignedAddress."""
    f = shade_frame
    light = dict(f["light"], blend="alpha")
    g = resolve.resolve_gbuffer_plain(f["vis"], f["attrs"], max_anisotropy=16)
    params = (ctypes.c_float * shade.N_PARAMS)(*shade.shade_params(**light))
    out = torch.empty((4,) + tuple(g.shape[1:]))
    lut = shade.srgb_table("cpu")
    for dtype, code, shift in (("float32", 0, 8), ("float16", 1, 4), ("bfloat16", 2, 2), ("srgb8", 3, 1)):
        tex = f["texels"][dtype]
        err = emu.tr_shade_gbuffer(g.data_ptr(), tex.data_ptr() + shift, tex.shape[0] - 1, code, lut.data_ptr(),
                                   f["cp"].data_ptr(), g.shape[1], g.shape[2], 16, ctypes.addressof(params),
                                   out.data_ptr(), None, None, None)
        assert err == 1, dtype
    tiles, page = f["tiles"], f["page"]
    plan = sampler.plan_tiles_plain(g, max_anisotropy=16, **tiles)
    err = emu.tr_sample(g.data_ptr(), page.data_ptr() + 2, page.shape[2], plan["table"].data_ptr(),
                        f["cp"].data_ptr(), tiles["tiles_x"], tiles["tiles_y"], tiles["tile_h"], tiles["tile_w"], 16,
                        ctypes.addressof(params), out.data_ptr(), None, None, None)
    assert err == 716


# ---------------------------------------------------------------------------
# The frame trace: the mark kernel (csrc/trace.cu) and the marks the render
# kernels stamp (common.cuh stamp_start, stamp_end).


def test_trace_mark_kernel(emu):
    """Marks 0, 1 and 6 of a frame: mark 0 takes the next sequence number
    from the device's counter and zeroes the words the render kernels
    stamp; mark 6 copies the frame's record (here with the stamped words
    planted) and counters into its slot of the ring, then the completion
    word. Monotonic times (the emulation's %globaltimer is the host's
    monotonic clock, Python's perf_counter_ns); the next frame takes the
    next slot, the ring wraps, and a calibration mark writes only its word."""
    import ctypes
    import time

    from tpurast_torch import tracing

    slots, S = 4, tracing.SLOT
    ring = torch.full(((slots + 1) * S,), -1, dtype=torch.int64)
    seq = torch.zeros(1, dtype=torch.int64)
    rec = torch.full((S,), -5, dtype=torch.int64)  # the record in flight

    def mark(i, ovf=None, mis=None):
        last = i == len(tracing.MARKS) - 1
        err = emu.tr_trace_mark(ring.data_ptr(), seq.data_ptr(), rec.data_ptr(), slots, i, int(last),
                                None if ovf is None else ovf.data_ptr(), None if mis is None else mis.data_ptr(),
                                None, None, None)
        assert err == 0

    def frame(ovf, mis):
        mark(0)
        assert rec[1 + 2:1 + 6].tolist() == [0, 0, 0, 0]  # the stamped words, zeroed
        mark(1)
        for i in tracing.STAMPED:  # as the kernels would stamp them
            rec[1 + i] = time.perf_counter_ns()
        mark(6, ovf, mis)

    t0 = time.perf_counter_ns()
    frame(torch.tensor(7, dtype=torch.int32), torch.tensor(3, dtype=torch.int32))
    t1 = time.perf_counter_ns()
    got = ring[1 * S:2 * S]
    times = got[1:1 + len(tracing.MARKS)]
    assert int(seq) == 1 and int(got[0]) == 1 and int(got[tracing.DONE]) == 1
    assert t0 <= int(times[0]) and bool((times[1:] >= times[:-1]).all()) and int(times[-1]) <= t1
    assert (int(got[tracing.OVERFLOW]), int(got[tracing.MISS])) == (7, 3)
    for _ in range(4):  # frames 2..5: frame 5 wraps into frame 1's slot
        frame(torch.tensor(0, dtype=torch.int32), torch.tensor(1, dtype=torch.int32))
    assert int(seq) == 5 and ring.view(slots + 1, S)[:slots, 0].tolist() == [4, 5, 2, 3]
    assert ring.view(slots + 1, S)[1, tracing.MISS] == 1
    mark(0)
    mark(6)  # no counters: 0
    assert ring.view(slots + 1, S)[2, tracing.OVERFLOW] == 0 and ring.view(slots + 1, S)[2, tracing.DONE] == 6
    assert emu.tr_trace_mark(ring.data_ptr(), seq.data_ptr(), rec.data_ptr(), slots, -1, 0, None, None, None, None,
                             None) == 0
    assert int(seq) == 6 and t1 <= int(ring[slots * S]) <= time.perf_counter_ns()
    # Mapped memory (plain zeroed memory here).
    emu.tr_trace_alloc.argtypes = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)]
    host, dev = ctypes.c_void_p(), ctypes.c_void_p()
    assert emu.tr_trace_alloc(64, ctypes.byref(host), ctypes.byref(dev)) == 0
    assert host.value == dev.value and bytes((ctypes.c_char * 64).from_address(host.value)) == bytes(64)


@pytest.mark.parametrize("kernel", ["raster", "resolve", "sample", "gather", "deferred"])
def test_render_kernels_stamp_the_frame_marks(emu, frame, shade_frame, kernel):
    """Given the addresses of two words of the frame's record, each render
    kernel's entry point stamps the time its first block starts into the
    first and raises the second to the time its last block ends (the
    emulation's %globaltimer is the host's perf_counter_ns), and writes
    the same output as without them."""
    import time

    f = shade_frame
    light = dict(f["light"], blend="alpha")
    tex = f["texels"]["float32"]
    if kernel == "raster":
        args, so, bins = _frame_case(frame)
        run = lambda m: _emu_raster(emu, so, bins, args, marks=m)  # noqa: E731
    elif kernel == "resolve":
        run = lambda m: _emu_resolve(emu, f["vis"], f["resolve_rows"], marks=m)  # noqa: E731
    elif kernel == "sample":
        g = resolve.resolve_gbuffer_plain(f["vis"], f["attrs"], max_anisotropy=16)
        plan = sampler.plan_tiles_plain(g, max_anisotropy=16, **f["tiles"])
        run = lambda m: _emu_sample(emu, g, f["page"], plan, f["cp"], f["tiles"], light, 16, marks=m)  # noqa: E731
    elif kernel == "gather":
        g = resolve.resolve_gbuffer_plain(f["vis"], f["attrs"], max_anisotropy=16)
        run = lambda m: _emu_shade(emu, "gather", tex, "float", f["cp"], light, 16, gbuf=g, marks=m)  # noqa: E731
    else:
        run = lambda m: _emu_shade(emu, "deferred", tex, "float", f["cp"], light, 16, fid=f["fid"],  # noqa: E731
                                   rows=f["rows"], marks=m)
    want = run((None, None))
    words = torch.zeros(2, dtype=torch.int64)
    t0 = time.perf_counter_ns()
    got = run((words.data_ptr(), words.data_ptr() + 8))
    t1 = time.perf_counter_ns()
    assert torch.equal(got, want)
    assert t0 <= int(words[0]) < int(words[1]) <= t1


# ---------------------------------------------------------------------------
# Pair binning (csrc/bin.cu tr_bin), through geometry.bin_pairs and
# bin_triangles with the emulated library in place of the card's.


def _bin_random_faces():
    """tests/test_torch_geometry.py's ~2k faces (small, huge, across the eye
    plane, off screen) through the port's setup at its 512x256 frame."""
    from test_torch_geometry import H as GH, W as GW, _random_faces, _view_proj

    corners = _random_faces()
    clip = geometry.transform_corners(torch.from_numpy(corners), torch.from_numpy(_view_proj()))
    so = geometry.triangle_setup(clip, None, corners.shape[0], GW, GH)
    return so["aabb"], so["valid"]


# case: (faces, tiles_x, tiles_y, tile_w, tile_h, ty_base, pair capacity ("half": half the pairs; None: bin_pairs),
#        tiles_per_face)
BIN_CASES = {
    "random_faces": ("random", 4, 8, 128, 32, 0, None, 8),
    "random_faces_slab": ("random", 4, 3, 128, 32, 2, None, 8),
    "orbit_frame": ("orbit", None, None, None, None, 0, None, 8),
    "no_faces": ("none", 4, 8, 128, 32, 0, None, 8),
    "no_face_valid": ("invalid", 4, 8, 128, 32, 0, None, 8),
    "every_face_huge": ("huge", 4, 8, 128, 32, 0, None, 8),
    "many_pairs_a_face": ("random", 4, 8, 128, 32, 0, None, 40),
    "y_buckets_past_8192_rows": ("tall", 2, 320, 128, 32, 0, None, 8),
    "two_tile_passes": ("4k", 30, 270, 128, 8, 0, None, 8),
    "scan": ("random", 4, 8, 128, 32, 0, 16384, 8),
    "scan_truncated": ("random", 4, 8, 128, 32, 0, "half", 8),
    "scan_two_tile_passes_truncated": ("4k", 30, 270, 128, 8, 0, "half", 8),
}


def _bin_case_inputs(case, frame):
    kind, tx, ty, tw, th, ty_base, cap, tpf = BIN_CASES[case]
    if kind == "orbit":
        r, kw, _, _, so, _ = frame
        aabb, valid, tx, ty, tw, th = so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"]
    elif kind in ("random", "none", "invalid"):
        aabb, valid = _bin_random_faces()
        aabb, valid = (aabb[:0], valid[:0]) if kind == "none" else (aabb, valid & (kind != "invalid"))
    elif kind == "huge":
        aabb, valid = bin_boxes(300, 512, 256, 3, 1.0)
    elif kind == "tall":
        aabb, valid = bin_boxes(3000, 256, 10240, 4, 0.05)
    else:  # 3840x2160 in 8x128 tiles: 8,100 tiles
        aabb, valid = bin_boxes(700, 3840, 2160, 5, 0.03, size=(1.0, 60.0), huge_size=(100.0, 400.0))
    grid = (aabb, valid, tx, ty, tw, th)
    if cap == "half":
        cap = int(geometry.bin_pairs(*grid, tiles_per_face=tpf, ty_base=ty_base)["offsets"][-1]) // 2
    return grid, dict(tiles_per_face=tpf, ty_base=ty_base), cap


@pytest.fixture
def emu_bin(emu, monkeypatch):
    """The kernel wrappers (geometry's binners and setup, and every other)
    on CPU tensors through their kernel path, with the emulated library in
    place of the card's (no stream)."""
    from tpurast_torch import kernels

    def call(name, *args):
        err = getattr(emu, name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), None)
        assert err == 0, f"{name}: error {err}"

    monkeypatch.setattr(kernels, "use_kernel", lambda *tensors: not kernels.plain_kernels_active())
    monkeypatch.setattr(_build, "call", call)
    monkeypatch.setattr(_build, "library", lambda: emu)


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_kernels(emu_bin, frame, case):
    """The binning kernels against the plain bin_pairs / bin_triangles:
    offsets, counts and overflow exactly; pair_faces and pair_tiles on the
    live prefix [0, offsets[-1]) (all that bin_pairs defines), bin_triangles'
    whole pair_faces buffer (0 past the binned pairs). The cases: the random
    faces of tests/test_torch_geometry.py (eye-plane crossers, more huge
    faces than HUGE_BUDGET), a slab of them (ty_base 2), the orbit frame,
    no faces, no valid face, every face huge, faces of more pairs than a
    lane writes, y-buckets clamped past 8,192 rows, 8,100 tiles (the tile
    sort in two passes), and the scan contract with room and with half the
    pairs' room. One launch a call (LAUNCHES["bin"])."""
    from tpurast_torch import kernels

    grid, kw, cap = _bin_case_inputs(case, frame)

    def binned():
        return geometry.bin_pairs(*grid, **kw) if cap is None else geometry.bin_triangles(*grid, cap, **kw)

    before = kernels.LAUNCHES["bin"]
    got = binned()
    assert kernels.LAUNCHES["bin"] == before + 1
    with kernels.plain_kernels():
        want = binned()
    assert kernels.LAUNCHES["bin"] == before + 1
    assert set(got) == set(want)
    for k in ("offsets", "counts", "overflow"):
        assert torch.equal(got[k], want[k]), k
    n = int(want["offsets"][-1])
    assert got["pair_faces"].shape == want["pair_faces"].shape
    if cap is None:
        assert torch.equal(got["pair_faces"][:n], want["pair_faces"][:n])
        assert torch.equal(got["pair_tiles"][:n], want["pair_tiles"][:n])
    else:
        assert torch.equal(got["pair_faces"], want["pair_faces"])
    slots = want["pair_tiles"].numel() if cap is None else cap
    assert (n == 0) == (BIN_CASES[case][0] in ("none", "invalid")) and n <= slots
    if case in ("random_faces", "every_face_huge", "two_tile_passes"):
        assert int(want["overflow"]) > 0, "more huge faces than HUGE_BUDGET"
    if case.endswith("truncated"):
        assert n == cap and int(want["overflow"]) > 0


# case: (tiles_y, ty_base, pair capacity (None: bin_pairs; "half": half the pairs))
NEAR_CASES = {"frame": (8, 0, None), "slab": (3, 2, None), "scan": (8, 0, 16384), "scan_truncated": (8, 0, "half")}


@pytest.mark.parametrize("case", list(NEAR_CASES))
def test_bin_kernels_near_boxes(emu_bin, case):
    """The binning kernels with near-plane boxes (tr_bin given clip: face_kernel
    reads a cut face's corners) against the plain binners with near= on
    tests/test_torch_memsafety.py's near_faces (faces across the eye plane
    through the setup, and crafted cut faces: behind the eye, on the eye
    plane, NaN, infinite and out-of-range corners, overflowing projections):
    offsets, counts, overflow, cut_faces and huge_faces exactly, the pairs
    on the live prefix (bin_triangles' whole buffer); one launch a call."""
    from test_torch_memsafety import near_faces

    from tpurast_torch import kernels

    aabb, valid, clip = near_faces()
    ty, ty_base, cap = NEAR_CASES[case]
    grid, near = (aabb, valid, 4, ty, 128, 32), (clip, 512, 256)
    if cap == "half":
        with kernels.plain_kernels():
            cap = int(geometry.bin_pairs(*grid, near=near)["offsets"][-1]) // 2

    def binned():
        if cap is None:
            return geometry.bin_pairs(*grid, ty_base=ty_base, near=near)
        return geometry.bin_triangles(*grid, cap, ty_base=ty_base, near=near)

    before = kernels.LAUNCHES["bin"]
    got = binned()
    assert kernels.LAUNCHES["bin"] == before + 1
    with kernels.plain_kernels():
        want = binned()
    assert set(got) == set(want) and {"cut_faces", "huge_faces"} <= set(want)
    for k in ("offsets", "counts", "overflow", "cut_faces", "huge_faces"):
        assert torch.equal(got[k], want[k]), k
    n = int(want["offsets"][-1])
    if cap is None:
        assert torch.equal(got["pair_faces"][:n], want["pair_faces"][:n])
        assert torch.equal(got["pair_tiles"][:n], want["pair_tiles"][:n])
    else:
        assert torch.equal(got["pair_faces"], want["pair_faces"])
    assert n > 0 and int(want["cut_faces"]) > 0 and int(want["huge_faces"]) > 0
    assert (n == cap) == case.endswith("truncated")


def test_trace_mark_kernel_carries_face_counts(emu):
    """tr_trace_mark: mark 6 copies the binner's cut and huge face counts
    into the record beside bin_overflow and window_miss_px (0 where a
    pointer is null, both of them null included)."""
    from tpurast_torch import tracing

    slots, S = 4, tracing.SLOT
    ring = torch.full(((slots + 1) * S,), -1, dtype=torch.int64)
    seq = torch.zeros(1, dtype=torch.int64)
    rec = torch.zeros((S,), dtype=torch.int64)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    counts = [i32(7), i32(3), i32(41), i32(65)]
    for last_counts in (counts, [counts[0], counts[1], None, counts[3]]):
        for i in (0, 1, 6):
            c = last_counts if i == 6 else [None] * 4
            assert emu.tr_trace_mark(ring.data_ptr(), seq.data_ptr(), rec.data_ptr(), slots, i, int(i == 6),
                                     *(None if t is None else t.data_ptr() for t in c), None) == 0
    got = ring.view(slots + 1, S)
    words = [tracing.OVERFLOW, tracing.MISS, tracing.CUT, tracing.HUGE, tracing.DONE]
    assert got[1, words].tolist() == [7, 3, 41, 65, 1]
    assert got[2, [tracing.CUT, tracing.HUGE, tracing.DONE]].tolist() == [0, 65, 2]
    for i in (0, 6):
        assert emu.tr_trace_mark(ring.data_ptr(), seq.data_ptr(), rec.data_ptr(), slots, i, int(i == 6),
                                 counts[0].data_ptr(), None, None, None, None) == 0
    assert got[3, [tracing.OVERFLOW, tracing.CUT, tracing.HUGE, tracing.DONE]].tolist() == [7, 0, 0, 3]


# ---------------------------------------------------------------------------
# Triangle setup (csrc/setup.cu tr_setup), through geometry.setup_faces with
# the emulated library in place of the card's.


@pytest.mark.parametrize("case", ["geometry_faces", *SETUP_CASES])
def test_setup_kernel(emu_bin, case):
    """The setup kernel against transform_corners and triangle_setup: the
    clip corners, setup, valid, aabb and det bit for bit (NaN where the
    plain version has NaN). The cases: tests/test_torch_geometry.py's
    2,048 faces (small, huge, across the eye plane, off screen) at its
    512x256 frame, and tests/test_torch_memsafety.py's SETUP_CASES: 1, 255,
    257 and 2,051 faces (no whole block), 2,051 rows of which 300 are
    padding past n_faces, with NaN and infinite corners, and faces on which
    a rounding decides (a cross product that a fused multiply-add would
    round otherwise, anchors halfway between pixels). One launch a call
    (LAUNCHES["setup"])."""
    from test_torch_geometry import H as GH, W as GW, _random_faces, _view_proj

    from tpurast_torch import kernels

    if case == "geometry_faces":
        corners = torch.from_numpy(_random_faces())
        args = (corners, torch.from_numpy(_view_proj()), corners.shape[0], GW, GH)
    else:
        args = setup_inputs(*SETUP_CASES[case])
    before = kernels.LAUNCHES["setup"]
    clip, got = geometry.setup_faces(*args)
    assert kernels.LAUNCHES["setup"] == before + 1
    with kernels.plain_kernels():
        clip_p, want = geometry.setup_faces(*args)
    assert kernels.LAUNCHES["setup"] == before + 1
    assert_same_bits(clip, clip_p, "clip")
    assert set(got) == set(want) == {"setup", "valid", "aabb", "det"}
    for k in want:
        assert_same_bits(got[k], want[k], k)
    if case == "geometry_faces":
        w = clip_p[..., 3]
        assert ((w <= 0).any(dim=1) & (w > 0).any(dim=1)).sum() > 50 and int(want["valid"].sum()) > 400
    if case.endswith("ties"):
        assert float(want["setup"][0, 2]) == 32784.0 and want["setup"][1:4, 16:18].tolist() == [
            [2.0, 0.0], [-2.0, 0.0], [0.0, 2.0]]
    if case.endswith("non_finite"):
        bad = ~torch.isfinite(args[0].reshape(-1, 9)).all(dim=1)
        assert int(bad.sum()) > 20 and bool(bad[args[2]:].any()) and not bool(want["valid"][bad].any())
        assert bool(torch.isnan(want["setup"]).any())


def test_setup_kernel_refuses_corners_off_the_grid(emu_bin):
    """Corners that do not start on the 16-byte grid (the kernel reads them
    in 16-byte words) are refused before the launch, as is a matrix that is
    not (4, 4) f32."""
    from tpurast_torch import kernels

    corners, vp, n, w, h = setup_inputs(64)
    before = kernels.LAUNCHES["setup"]
    off = torch.empty(corners.numel() + 1)[1:].view(corners.shape).copy_(corners)
    with pytest.raises(ValueError, match="16-byte grid"):
        geometry.setup_faces(off, vp, n, w, h)
    with pytest.raises(TypeError, match="view_proj"):
        geometry.setup_faces(corners, vp.double(), n, w, h)
    assert kernels.LAUNCHES["setup"] == before


def test_render_frame_with_the_emulated_kernels(emu_bin):
    """render_frame with every kernel emulated (the setup kernel first, and
    the binning, raster, resolve, plan and sample kernels after it) against
    the same frames inside plain_kernels(): color, depth and the counters
    equal, one setup launch a frame."""
    from tpurast_torch import kernels
    from tpurast_torch.renderer import render_frame

    r = Renderer(build_orbit_scene(seed=2, **SMALL_SCENE), RendererConfig(width=256, height=128), device="cpu")
    kernels.reset_launches()
    for cam in orbit_track(8)[1:3]:
        vp, cp = r.frame_uniforms(cam)
        got = render_frame(r.scene, vp, cp, **r._frame_kwargs)
        with kernels.plain_kernels():
            want = render_frame(r.scene, vp, cp, **r._frame_kwargs)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert int((want["depth"] > 0).sum()) > 1000
    assert kernels.LAUNCHES["setup"] == kernels.LAUNCHES["raster"] == kernels.LAUNCHES["encode"] == 2


def test_deferred_frame_with_the_emulated_kernels(emu_bin):
    """render_frame on the deferred path with every kernel emulated (setup,
    binning, raster and the deferred kernel, which reads each pixel's face
    row from the frame's setup rows and the scene's shade table, the
    Renderer's one face table) against the same frames inside
    plain_kernels(): color, depth and the counters equal, one deferred
    launch a frame and no resolve."""
    from tpurast_torch import kernels
    from tpurast_torch.renderer import render_frame

    cfg = RendererConfig(width=128, height=64, shading="deferred")
    r = Renderer(build_orbit_scene(seed=2, **SMALL_SCENE), cfg, device="cpu")
    assert "shade_table" in r.scene and "resolve_table" not in r.scene
    kernels.reset_launches()
    for cam in orbit_track(8)[1:3]:
        vp, cp = r.frame_uniforms(cam)
        got = render_frame(r.scene, vp, cp, **r._frame_kwargs)
        with kernels.plain_kernels():
            want = render_frame(r.scene, vp, cp, **r._frame_kwargs)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert int((want["depth"] > 0).sum()) > 1000
    assert kernels.LAUNCHES["deferred"] == kernels.LAUNCHES["raster"] == kernels.LAUNCHES["encode"] == 2
    assert kernels.LAUNCHES["resolve"] == 0


# ---------------------------------------------------------------------------
# The sRGB encode (csrc/encode.cu tr_encode), through present.encode_srgb_u8
# with the emulated library in place of the card's.


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_kernel(emu_bin, case):
    """The encode kernel against encode_srgb_u8_plain, one launch a call
    (LAUNCHES["encode"]): a frame on the tile grid with padded rows (16-byte
    loads, 4-byte stores), a width off the 4-pixel grid (a byte a pixel), a
    slab's crop, rows off the 16-byte grid (a 4-byte load a pixel), and
    encode_specials() in every plane: the half-LSB ties of x * 255 in both
    segments of the curve and in alpha, the threshold and its neighbours,
    NaN, the infinities, -0.0, 0, 1. Bit for bit against the plain
    arithmetic with the host's powf, and within 1 LSB of the plain version
    at a ten-thousandth of a random frame's values at most
    (assert_encode_equal)."""
    from tpurast_torch import kernels

    planes, w, h = encode_inputs(case)
    before = kernels.LAUNCHES["encode"]
    got = present.encode_srgb_u8(planes, w, h)
    assert kernels.LAUNCHES["encode"] == before + 1
    # A tie sits on a rounding boundary: wherever the two pows part there, the plain version is 1 LSB off.
    assert assert_encode_equal(got, planes, w, h) <= (0.02 if case == "specials" else 0.0001) * got.numel()
    if case == "specials":
        assert encode_specials().size > 700
    else:
        assert int((planes[:, :h, :w] < 0).sum()) > 0 and int((planes[:, :h, :w] > 1).sum()) > 0


def test_encode_kernel_refuses_bad_planes(emu_bin):
    """Planes that are not contiguous (4, Hp, Wp) f32, or a crop past them,
    are refused before the launch."""
    from tpurast_torch import kernels

    planes, w, h = encode_inputs("frame_grid")
    before = kernels.LAUNCHES["encode"]
    with pytest.raises(TypeError, match="planes"):
        present.encode_srgb_u8(planes.double(), w, h)
    with pytest.raises(ValueError, match=r"\(4, Hp, Wp\)"):
        present.encode_srgb_u8(planes[:3].contiguous(), w, h)
    with pytest.raises(ValueError, match="contiguous"):
        present.encode_srgb_u8(planes.transpose(1, 2), w, h)
    with pytest.raises(ValueError, match="does not fit"):
        present.encode_srgb_u8(planes, planes.shape[2] + 1, h)
    assert kernels.LAUNCHES["encode"] == before


def test_encode_on_cpu_tensors_takes_the_plain_version():
    """On CPU tensors encode_srgb_u8 is encode_srgb_u8_plain: the same
    bytes, no launch counted."""
    from tpurast_torch import kernels

    planes, w, h = encode_inputs("odd_width")
    before = kernels.LAUNCHES["encode"]
    assert torch.equal(present.encode_srgb_u8(planes, w, h), present.encode_srgb_u8_plain(planes, w, h))
    assert kernels.LAUNCHES["encode"] == before


def test_slab_frame_with_the_emulated_kernels(emu_bin):
    """render_frame of a slab (its first tile row 2, a crop of 20 of its
    32 rows, as parallel.py's last slab of a frame crops) with every kernel
    emulated, the encode reading the slab's padded planes, against the same
    slab inside plain_kernels(): color, depth and the counters equal, one
    encode launch."""
    from tpurast_torch import kernels
    from tpurast_torch.renderer import render_frame

    r = Renderer(build_orbit_scene(seed=2, **SMALL_SCENE), RendererConfig(width=256, height=128), device="cpu")
    vp, cp = r.frame_uniforms(orbit_track(8)[1])
    kw = dict(r._frame_kwargs, tiles_y=1, tile_row_offset=2, crop_height=20)
    kernels.reset_launches()
    got = render_frame(r.scene, vp, cp, **kw)
    with kernels.plain_kernels():
        want = render_frame(r.scene, vp, cp, **kw)
    assert got["color"].shape == (4, 20, 256) and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int((want["depth"] > 0).sum()) > 2000
    assert kernels.LAUNCHES["encode"] == kernels.LAUNCHES["raster"] == 1


def test_bin_kernels_refuse_mixed_devices():
    """A call with its tensors on two devices raises (kernels.use_kernel)
    before anything is binned or launched."""
    from tpurast_torch import kernels

    aabb, valid = bin_boxes(16, 512, 256, 6, 0.0)
    before = kernels.LAUNCHES["bin"]
    for binner in (geometry.bin_pairs, lambda *a: geometry.bin_triangles(*a, 64)):
        with pytest.raises(ValueError, match="all be on the CPU or all on one CUDA device"):
            binner(aabb, valid.to("meta"), 4, 8, 128, 32)
    assert kernels.LAUNCHES["bin"] == before
