"""The CUDA kernels at tiles past 4096 px, on the CPU (the host emulation
of tests/test_torch_csrc.py, whose build this module shares).

Raster, plan and sample at LARGE_TILES on tests/test_torch_memsafety.py's
small orbit scene: the raster's sub-rectangle units, the plan's groups of
4096 px with their state in scratch, partial sub-rectangles, a frame off
the tile grid; and the plan on stacked many-texture tiles of 64x128. Each
against its plain version: raster depth and face id exact, plan table and
assignment exact, sample within 1 LSB after the sRGB encode.

Time on one worker: about 30 s (the plain raster and plan at the large
tiles).
"""

import pytest
import torch

from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.kernels import geometry, present, raster, resolve, sampler
from tpurast_torch.renderer import Renderer
from test_torch_csrc import _emu_plan, _emu_raster, _emu_sample, emu_library
from test_torch_memsafety import SCENE as SMALL_SCENE, texture_grid_gbuf
from test_torch_scene import numpy_bc_decoders  # noqa: F401  (module-wide autouse)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emu_library(tmp_path_factory)


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
