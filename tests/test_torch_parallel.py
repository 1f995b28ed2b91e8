"""tpurast_torch slabs (render_frame(tile_row_offset=, crop_height=) and
parallel.py) on the CPU.

tests/test_sharding.py is the model (the reference's sharded frame equal
to its single frame bit for bit); it is slow and reads the data directory,
so here the scene is tests/test_torch_runtime.py's TINY orbit scene:

  * make_sharded_renderer's frames put together equal the Renderer's frame
    bit for bit, color and depth, with the same bin_overflow and
    window_miss_px, for forward + window, forward + gather and deferred,
    at 2 and 8 slabs and tile_h 8 and 32 (128x72: 3 or 9 tile rows,
    padded, so some slabs lie wholly below the viewport), and with
    binning="scan";
  * make_sharded_renderer picks the pair buffer, binning, sampler and texel
    format as the Renderer does, and tile_row_offset may be a 0-dim
    tensor;
  * one slab of the plain path (tile rows 3-5 of a 128x64 frame in 8-row
    tiles) against the reference's render_frame(tile_row_offset=,
    crop_height=) in interpret mode: face id exact, depth within 5 ulp,
    the G-buffer within tests/test_torch_resolve.py's budgets (plane 14
    within 2e-6, see test_slab_gbuffer_matches_reference), color within
    1 LSB.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurast.config import RendererConfig
from tpurast.renderer import Renderer as RefRenderer
from tpurast.renderer import render_frame as ref_render_frame
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.kernels import resolve
from tpurast_torch.parallel import make_sharded_renderer
from tpurast_torch.renderer import Renderer, render_frame
from test_torch_raster import depth_ulps
from test_torch_runtime import TINY
from test_torch_scene import numpy_bc_decoders, reference_scene  # noqa: F401  (module-wide autouse)

W, H = 128, 72
PATHS = {"window": {}, "gather": dict(sampler="gather"), "deferred": dict(shading="deferred"),
         "scan": dict(binning="scan")}


@pytest.fixture(scope="module")
def scene():
    return build_orbit_scene(seed=1, **TINY)


@pytest.fixture(scope="module")
def cam():
    return orbit_track(8)[3]


@pytest.mark.parametrize("tile_h", [8, 32])
@pytest.mark.parametrize("path", list(PATHS))
def test_slabs_put_together_are_the_frame(scene, cam, path, tile_h):
    cfg = RendererConfig(width=W, height=H, tile_h=tile_h, **PATHS[path])
    r = Renderer(scene, cfg, device="cpu")
    uniforms = r.frame_uniforms(cam)
    want = r.render_with_uniforms(*uniforms)
    assert 0.1 < float((want["depth"] > 0).float().mean()) < 0.95
    for n_slabs in (2, 8):
        got = make_sharded_renderer(r.scene, cfg, n_slabs, W, H)(r.scene, *uniforms)
        assert set(got) == set(want)
        assert got["color"].shape == (4, H, W) and got["color"].dtype == torch.uint8
        assert torch.equal(got["color"], want["color"]), f"{n_slabs} slabs: color"
        assert torch.equal(got["depth"], want["depth"]), f"{n_slabs} slabs: depth"
        for k in ("bin_overflow", "window_miss_px"):
            assert got[k].dtype == torch.int32 and int(got[k]) == int(want[k]), k


@pytest.mark.parametrize(
    "change",
    [{}, dict(sampler="gather", texture_dtype="srgb8"), dict(shading="deferred"), dict(binning="scan"),
     dict(bin_capacity=5000)],
    ids=["window", "gather_srgb8", "deferred", "scan", "capacity"],
)
def test_sharded_renderer_chooses_as_the_renderer(scene, change):
    cfg = RendererConfig(width=W, height=H, **change)
    r = Renderer(scene, cfg, device="cpu")
    fn = make_sharded_renderer(r.scene, cfg, 2, W, H)
    for k in ("bin_capacity", "binning", "sampler", "texture_format", "tiles_x", "shading"):
        assert fn.keywords[k] == r._frame_kwargs[k], k
    assert fn.keywords["tiles_y_per_slab"] * 2 == -(-r.tiles_y // 2) * 2
    with pytest.raises(ValueError, match="n_slabs"):
        make_sharded_renderer(r.scene, cfg, 0, W, H)


def test_tile_row_offset_may_be_a_tensor(scene, cam):
    r = Renderer(scene, RendererConfig(width=W, height=H, tile_h=8), device="cpu")
    kw = dict(r._frame_kwargs, tiles_y=3, crop_height=24)
    a = render_frame(r.scene, *r.frame_uniforms(cam), **kw, tile_row_offset=2)
    b = render_frame(r.scene, *r.frame_uniforms(cam), **kw, tile_row_offset=torch.tensor(2, dtype=torch.int32))
    full = r.render(cam)
    assert torch.equal(a["color"], b["color"]) and torch.equal(a["color"], full["color"][:, 16:40])
    assert torch.equal(a["depth"], full["depth"][16:40])


SLAB_ROW, SLAB_ROWS, SLAB_TILE_H = 3, 3, 8


@pytest.fixture(scope="module")
def slab_frames(scene, cam):
    """One slab through both packages, as the color frame and as the
    G-buffer (computed once: interpret mode is slow)."""
    cfg = RendererConfig(width=128, height=64, tile_h=SLAB_TILE_H, segment_headroom=512)
    ref = RefRenderer(reference_scene(scene), cfg)
    port = Renderer(scene, cfg, device="cpu")
    slab = dict(tiles_y=SLAB_ROWS, crop_height=SLAB_ROWS * SLAB_TILE_H)
    out = {}
    for output in ("srgb_u8", "gbuf"):
        r = ref_render_frame(ref.scene, *ref.frame_uniforms(cam), **dict(
            ref._frame_kwargs, output=output, tile_row_offset=jnp.int32(SLAB_ROW), **slab))
        p = render_frame(port.scene, *port.frame_uniforms(cam), **dict(
            port._frame_kwargs, output=output, tile_row_offset=SLAB_ROW, **slab))
        out[output] = ({k: np.asarray(v) for k, v in r.items()}, {k: v.numpy() for k, v in p.items()})
    return out


def test_slab_color_and_depth_match_reference(slab_frames):
    ref, port = slab_frames["srgb_u8"]
    assert port["color"].shape == ref["color"].shape == (4, SLAB_ROWS * SLAB_TILE_H, 128)
    assert np.abs(port["color"].astype(np.int32) - ref["color"].astype(np.int32)).max() <= 1
    covered = ref["depth"] > 0
    assert 0.2 < covered.mean() < 0.95
    np.testing.assert_array_equal(port["depth"] > 0, covered)
    assert depth_ulps(port["depth"], ref["depth"]).max() <= 5
    assert int(port["bin_overflow"]) == int(ref["bin_overflow"]) == 0
    assert int(port["window_miss_px"]) == int(ref["window_miss_px"])


def test_slab_gbuffer_matches_reference(slab_frames):
    """tests/test_torch_resolve.py's budgets, but for plane 14 (the major
    axis' du): 2 of its 3,072 values lie 1.46e-6 from the reference's
    (atol 2e-6 here). The reference's whole frame differs from the port's
    at the same two pixels by 1.85e-6: the FMA contraction of
    gx*esum - nval*d_x in its interpret-mode kernel (ROADMAP queue 3), not
    the slab, whose rows are the whole frame's bit for bit on both sides
    (test_slab_is_the_frames_rows; tests/test_sharding.py)."""
    ref, port = slab_frames["gbuf"]
    f_r, g_r, g_p = ref["fid"], ref["gbuf"], port["gbuf"]
    np.testing.assert_array_equal(port["fid"], f_r)
    assert (f_r >= 0).sum() > 1000
    flip = (g_r[19] != g_p[19]) & (f_r >= 0)
    assert flip.sum() <= 0.001 * (f_r >= 0).sum()
    keep = ~flip
    for i in range(resolve.A_OUT):
        if i in resolve.INT_PLANES:
            np.testing.assert_array_equal(g_p[i][keep], g_r[i][keep], err_msg=f"plane {i}")
        else:
            rtol, atol = {13: (0.0, 8e-6), 17: (0.0, 3e-6), 14: (1e-5, 2e-6)}.get(i, (1e-5, 1e-6))
            np.testing.assert_allclose(g_p[i][keep], g_r[i][keep], rtol=rtol, atol=atol, err_msg=f"plane {i}")


def test_slab_is_the_frames_rows(scene, cam):
    """The same slab on the port is rows 24-47 of its whole frame."""
    cfg = RendererConfig(width=128, height=64, tile_h=SLAB_TILE_H)
    r = Renderer(scene, cfg, device="cpu")
    rows = slice(SLAB_ROW * SLAB_TILE_H, (SLAB_ROW + SLAB_ROWS) * SLAB_TILE_H)
    kw = dict(r._frame_kwargs, output="gbuf", tiles_y=SLAB_ROWS, tile_row_offset=SLAB_ROW)
    slab = render_frame(r.scene, *r.frame_uniforms(cam), **kw)
    g, fid = r.debug_gbuf(cam, with_fid=True)
    assert torch.equal(slab["gbuf"], g[:, rows]) and torch.equal(slab["fid"], fid[rows])
    with pytest.raises(ValueError, match="tile_h"):
        resolve.resolve_gbuffer(torch.zeros((2, 8, 128)), torch.zeros((1, resolve.A_IN)), tile_row_offset=1)


def test_scan_renderer_sizes_its_buffer_as_the_reference(scene):
    for change in ({}, dict(binning="scan"), dict(binning="scan", bin_capacity=1000), dict(binning="auto")):
        cfg = RendererConfig(width=W, height=H, **change)
        ref, port = RefRenderer(reference_scene(scene), cfg), Renderer(scene, cfg, device="cpu")
        assert (port.binning, port.bin_capacity) == (ref.binning, ref.bin_capacity)
    with pytest.raises(ValueError, match="binning"):
        Renderer(scene, dataclasses.replace(cfg, binning="sorted"), device="cpu")
