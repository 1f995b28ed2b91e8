"""tpurast_torch slabs (render_frame(tile_row_offset=, crop_height=) and
parallel.py) on the CPU.

tests/test_sharding.py is the model (the reference's sharded frame equal
to its single frame bit for bit); it is slow and reads the data directory,
so here the scene is tests/test_torch_runtime.py's TINY orbit scene:

  * make_sharded_renderer's frames put together equal the Renderer's frame
    bit for bit, color and depth, with the same bin_overflow and
    window_miss_px, for forward + window, forward + gather and deferred,
    at 2 and 8 slabs, on the device lists ["cpu"] * 2 and ["cpu"] * 4 and
    through MeshFrame (the join of several devices), at tile_h 8 and 32
    (128x72: 3 or 9 tile rows, padded, so some slabs lie wholly below the
    viewport), and with binning="scan";
  * the reference's make_sharded_renderer on a 2-device virtual CPU mesh
    (its shard_map, interpret mode) against the port's over ["cpu"] * 2
    at 128x64: color within 1 LSB, the same covered pixels, depth within
    5 ulp, the counters equal;
  * device.scene.replicate copies every tensor and keeps the page the
    (4, PH, PW) view of an interleaved copy; MeshFrame makes one replica
    per distinct device ("meta" stands in for a second card);
  * parallel.main(["--devices", "2", "--device", "cpu"]) (dryrun) at
    TINY;
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
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpurast.config import RendererConfig
from tpurast.parallel import make_sharded_renderer as ref_make_sharded_renderer
from tpurast.renderer import Renderer as RefRenderer
from tpurast.renderer import render_frame as ref_render_frame
from tpurast_torch import parallel
from tpurast_torch.device import scene as scene_mod
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.kernels import resolve
from tpurast_torch.parallel import MeshFrame, make_sharded_renderer
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
    """At 2 and 8 slabs on the scene's device, on the device lists
    ["cpu"] * 2 and ["cpu"] * 4, and through MeshFrame (the join of
    several devices) over ["cpu"] * 4."""
    cfg = RendererConfig(width=W, height=H, tile_h=tile_h, **PATHS[path])
    r = Renderer(scene, cfg, device="cpu")
    uniforms = r.frame_uniforms(cam)
    want = r.render_with_uniforms(*uniforms)
    assert 0.1 < float((want["depth"] > 0).float().mean()) < 0.95
    fns = {f"{n} slabs": make_sharded_renderer(r.scene, cfg, n, W, H) for n in (2, 8)}
    for n in (2, 4):
        fns[f"['cpu'] * {n}"] = make_sharded_renderer(r.scene, cfg, ["cpu"] * n, W, H)
    kw = {k: v for k, v in fns["['cpu'] * 4"].keywords.items() if k != "n_slabs"}
    fns["MeshFrame"] = MeshFrame(r.scene, ["cpu"] * 4, kw)
    for label, fn in fns.items():
        got = fn(r.scene, *uniforms)
        assert set(got) == set(want)
        assert got["color"].shape == (4, H, W) and got["color"].dtype == torch.uint8
        assert torch.equal(got["color"], want["color"]), f"{label}: color"
        assert torch.equal(got["depth"], want["depth"]), f"{label}: depth"
        for k in ("bin_overflow", "window_miss_px"):
            assert got[k].dtype == torch.int32 and got[k].dim() == 0 and int(got[k]) == int(want[k]), k
        assert all(v.device == torch.device("cpu") for v in got.values())


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
        resolve.resolve_gbuffer(torch.zeros((2, 8, 128)), torch.zeros((1, 24)), torch.zeros((1, resolve.TABLE_WIDTH)),
                                tile_row_offset=1)


def test_scan_renderer_sizes_its_buffer_as_the_reference(scene):
    for change in ({}, dict(binning="scan"), dict(binning="scan", bin_capacity=1000), dict(binning="auto")):
        cfg = RendererConfig(width=W, height=H, **change)
        ref, port = RefRenderer(reference_scene(scene), cfg), Renderer(scene, cfg, device="cpu")
        assert (port.binning, port.bin_capacity) == (ref.binning, ref.bin_capacity)
    with pytest.raises(ValueError, match="binning"):
        Renderer(scene, dataclasses.replace(cfg, binning="sorted"), device="cpu")


@pytest.fixture(scope="module")
def mesh_frames(scene, cam):
    """The reference's make_sharded_renderer on a 2-device virtual CPU mesh
    (its shard_map; interpret mode) and the port's over ["cpu"] * 2, at
    128x64 (computed once: interpret mode is slow)."""
    cfg = RendererConfig(width=128, height=64, segment_headroom=512)
    ref = RefRenderer(reference_scene(scene), cfg)
    mesh = Mesh(np.array(jax.devices()[:2]), ("tiles",))
    ref_fn = ref_make_sharded_renderer(ref.scene, cfg, mesh, 128, 64)
    port = Renderer(scene, cfg, device="cpu")
    got = make_sharded_renderer(port.scene, cfg, ["cpu"] * 2, 128, 64)(port.scene, *port.frame_uniforms(cam))
    want = ref_fn(ref.scene, *ref.frame_uniforms(cam))
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


def test_mesh_frame_matches_reference(mesh_frames):
    """tests/test_torch_parallel.py's slab budgets on the whole 2-device
    frame: color within 1 LSB, the same covered pixels, depth within 5 ulp,
    both counters equal."""
    ref, port = mesh_frames
    assert port["color"].shape == ref["color"].shape == (4, 64, 128)
    assert np.abs(port["color"].astype(np.int32) - ref["color"].astype(np.int32)).max() <= 1
    covered = ref["depth"] > 0
    assert 0.1 < covered.mean() < 0.95
    np.testing.assert_array_equal(port["depth"] > 0, covered)
    assert depth_ulps(port["depth"], ref["depth"]).max() <= 5
    for k in ("bin_overflow", "window_miss_px"):
        assert port[k].shape == () and int(port[k]) == int(ref[k]), k


def test_replicas_copy_every_tensor_and_keep_the_page_layout(scene, monkeypatch):
    """replicate: every tensor equal, the page the (4, PH, PW) view of an
    interleaved copy; MeshFrame makes one replica per distinct device (the
    "meta" device stands in for a second card) and keeps the scene on its
    own device."""
    r = Renderer(scene, RendererConfig(width=W, height=H), device="cpu")
    page = r.scene["atlas"]["page"]
    _, ph, pw = page.shape
    for device in ("cpu", "meta"):
        rep = scene_mod.replicate(r.scene, device)
        assert set(rep) == set(r.scene) and set(rep["atlas"]) == set(r.scene["atlas"])
        assert rep["n_faces"] == r.scene["n_faces"]
        assert rep["atlas"]["page"].stride() == (1, 4 * pw, 4) and rep["atlas"]["page"].shape == (4, ph, pw)
        pairs = [(rep[k], v) for k, v in r.scene.items() if isinstance(v, torch.Tensor)]
        pairs += [(rep["atlas"][k], v) for k, v in r.scene["atlas"].items()]
        for a, b in pairs:
            assert a.device == torch.device(device) and a.dtype == b.dtype and a.shape == b.shape
            assert device == "meta" or torch.equal(a, b)
    with pytest.raises(ValueError, match="interleaved"):
        scene_mod.replicate(dict(r.scene, atlas=dict(r.scene["atlas"], page=page.contiguous())), "cpu")

    made = []
    monkeypatch.setattr(parallel, "replicate", lambda s, d: made.append(d) or scene_mod.replicate(s, d))
    kw = {k: v for k, v in make_sharded_renderer(r.scene, r.config, 4, W, H).keywords.items() if k != "n_slabs"}
    fn = MeshFrame(r.scene, ["cpu", "meta", "cpu", "meta"], kw)
    assert made == [torch.device("meta")]
    assert fn.replicas[torch.device("cpu")] is r.scene and set(fn.replicas) == {torch.device(d) for d in ("cpu", "meta")}
    assert fn.slots == [(torch.device(d), j) for d, j in (("cpu", 0), ("meta", 0), ("cpu", 1), ("meta", 1))]
    assert scene_mod.scene_bytes(fn.replicas[torch.device("meta")]) == scene_mod.scene_bytes(r.scene) > page.numel() * 2


def test_dryrun_on_the_cpu(monkeypatch, capsys):
    """parallel.main(["--devices", "2", "--device", "cpu"]) at TINY: the
    two slabs equal the single frame; dryrun's line; "cuda" without a card
    raises."""
    monkeypatch.setattr(scene_mod, "build_orbit_scene", functools.partial(build_orbit_scene, **TINY))
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE", "0")
    monkeypatch.setattr(parallel, "dryrun", functools.partial(parallel.dryrun, width=W, height=H, frames=2))
    assert parallel.main(["--devices", "2", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["devices"] == ["cpu", "cpu"] and out["equal"] is True and out["slab_rows"] == 64
    assert out["graphs"] == 0 and out["replica_bytes"] == {"cpu": 0} and out["card"] == "cpu"
    assert out["sharded_ms"] > 0 and out["single_ms"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.dryrun(2)
