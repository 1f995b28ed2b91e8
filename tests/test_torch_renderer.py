"""tpurast_torch Renderer end to end against the JAX reference (CPU).

chip_smoke.py's procedural scene, cut to 256x128 with a smaller floor,
fewer spheres and 128^2 textures, through tpurast.renderer.Renderer and
tpurast_torch.renderer.Renderer on the same camera: sRGB u8 color within
1 LSB, linear color within 1e-3 (largest measured: 8.7e-4; the reference
and the port sample the same bf16 page with differently rounded x
weights, see tpurast_torch/kernels/sampler.py), depth within 5 ulp
(largest measured: 4; XLA:CPU FMA contraction, tests/test_torch_raster.py),
same bin_overflow and window_miss_px. At
512x256 the same scene shows a reference fault: the windowed sampler's
plan bands miss texels of wrap-crossing footprints on mips at most 255
texels wide (ROADMAP queue 3); the port follows the reference's gather
path there.

The row-atlas paths on the same scene and camera: the forward+gather
frame (sampler="gather", f16 and srgb8 texels) and the deferred frame
(shading="deferred") within 1 LSB of the reference's, depth within 5
ulp; the port's forward+gather frame equal to its deferred frame bit for
bit (the reference's invariant, tests/test_pipeline.py:209-239), at
max_anisotropy 16 and 4; a scene without pages rendered through the
gather sampler; the Renderer's sampler, texture dtype and texel format
chosen as the reference's are, and the atlas rows uploaded only for the
gather paths. Also the Renderer surface: output="gbuf" and "linear",
frame_uniforms, render_to_host, the zero-extent recreate_swapchain, and
the paths left to later work (scan binning, slabs) raising
NotImplementedError. The runtime (stage= prefixes, Engine, Presenter, the
bench) is held in tests/test_torch_runtime.py.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from tpurast.config import RendererConfig
from tpurast.renderer import Renderer as RefRenderer
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.renderer import Renderer, render_frame
from test_torch_raster import depth_ulps
from test_torch_scene import numpy_bc_decoders, reference_scene  # noqa: F401  (module-wide autouse)

CFG = RendererConfig(width=256, height=128, segment_headroom=512)


@pytest.fixture(scope="module")
def scene():
    return build_orbit_scene(seed=0, floor_quads=64, spheres=4, rings=16, segments=16, tex_size=128, n_textures=4)


@pytest.fixture(scope="module")
def cam():
    return orbit_track(8)[3]


@pytest.fixture(scope="module")
def scene_ref(scene):
    """The same scene as the reference's record."""
    return reference_scene(scene)


@pytest.fixture(scope="module")
def port(scene):
    return Renderer(scene, CFG, device="cpu")


@pytest.fixture(scope="module", params=["srgb_u8", "linear"])
def frames(request, scene, scene_ref, cam):
    ref = RefRenderer(scene_ref, CFG, output=request.param).render(cam)
    port = Renderer(scene, CFG, output=request.param, device="cpu").render(cam)
    return request.param, {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in port.items()}


def test_frame_matches_reference(frames):
    output, ref, port = frames
    assert set(port) == set(ref) == {"color", "depth", "bin_overflow", "window_miss_px"}
    assert port["color"].shape == ref["color"].shape == (4, 128, 256)
    assert port["color"].dtype == ref["color"].dtype
    if output == "srgb_u8":
        diff = np.abs(port["color"].astype(np.int32) - ref["color"].astype(np.int32))
        assert diff.max() <= 1
    else:
        np.testing.assert_allclose(port["color"], ref["color"], rtol=0, atol=1e-3)
    covered = ref["depth"] > 0
    assert 0.05 < covered.mean() < 0.95
    np.testing.assert_array_equal(port["depth"] > 0, covered)
    assert depth_ulps(port["depth"], ref["depth"]).max() <= 5
    assert int(port["bin_overflow"]) == int(ref["bin_overflow"]) == 0
    assert int(port["window_miss_px"]) == int(ref["window_miss_px"])


def test_frame_follows_gather_where_reference_window_bands_miss(scene, scene_ref):
    cfg = dataclasses.replace(CFG, width=512, height=256, segment_headroom=1024)
    cam0 = orbit_track(8)[0]
    window = np.asarray(RefRenderer(scene_ref, cfg).render(cam0)["color"]).astype(np.int32)
    gather = np.asarray(RefRenderer(scene_ref, dataclasses.replace(cfg, sampler="gather")).render(cam0)["color"])
    port = Renderer(scene, cfg, device="cpu").render(cam0)["color"].numpy().astype(np.int32)
    assert (np.abs(window - gather).max(axis=0) > 1).sum() > 10  # the reference fault shows here
    assert np.abs(port - gather).max() <= 1


GATHER_PATHS = {
    "gather": dict(sampler="gather"),
    "gather_srgb8": dict(sampler="gather", texture_dtype="srgb8"),
    "deferred": dict(shading="deferred"),
}


@pytest.fixture(scope="module", params=list(GATHER_PATHS))
def gather_frames(request, scene, scene_ref, cam):
    cfg = dataclasses.replace(CFG, **GATHER_PATHS[request.param])
    ref = RefRenderer(scene_ref, cfg).render(cam)
    port = Renderer(scene, cfg, device="cpu").render(cam)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in port.items()}


def test_gather_paths_match_reference(gather_frames):
    ref, port = gather_frames
    assert set(port) == set(ref)
    assert port["color"].shape == ref["color"].shape == (4, 128, 256) and port["color"].dtype == np.uint8
    diff = np.abs(port["color"].astype(np.int32) - ref["color"].astype(np.int32))
    assert diff.max() <= 1, f"max {diff.max()} LSB at {(diff > 1).sum()} values"
    covered = ref["depth"] > 0
    assert 0.05 < covered.mean() < 0.95
    np.testing.assert_array_equal(port["depth"] > 0, covered)
    assert depth_ulps(port["depth"], ref["depth"]).max() <= 5
    assert int(port["bin_overflow"]) == int(ref["bin_overflow"]) == 0
    assert int(port["window_miss_px"]) == int(ref["window_miss_px"]) == 0


@pytest.mark.parametrize("aniso", [16, 4])
def test_forward_gather_equals_deferred(scene, cam, aniso):
    kw = dict(max_anisotropy=aniso, texture_dtype="float32")
    fwd = Renderer(scene, dataclasses.replace(CFG, sampler="gather", **kw), device="cpu")
    dfr = Renderer(scene, dataclasses.replace(CFG, shading="deferred", **kw), device="cpu")
    a, b = fwd.render(cam), dfr.render(cam)
    assert torch.equal(a["color"], b["color"])
    assert torch.equal(a["depth"], b["depth"])
    # debug_gbuf stays the forward G-buffer whatever the shading.
    assert torch.equal(fwd.debug_gbuf(cam), dfr.debug_gbuf(cam))


def test_scene_without_pages_renders_through_gather(scene, cam):
    pageless = dataclasses.replace(scene, pages=None)
    r = Renderer(pageless, CFG, device="cpu")
    assert r.sampler == "gather" and "page" not in r.scene["atlas"]
    want = Renderer(scene, dataclasses.replace(CFG, sampler="gather"), device="cpu").render(cam)
    got = r.render(cam)
    assert torch.equal(got["color"], want["color"]) and torch.equal(got["depth"], want["depth"])


@pytest.mark.parametrize(
    "change",
    [
        {},
        dict(sampler="window"),
        dict(sampler="gather"),
        dict(shading="deferred"),
        dict(shading="deferred", sampler="window"),
        dict(sampler="gather", texture_dtype="srgb8"),
        dict(sampler="gather", texture_dtype="bfloat16"),
        dict(texture_dtype="float32"),
    ],
    ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()) or "default",
)
def test_sampler_and_texture_choice_follow_reference(scene, scene_ref, change):
    cfg = dataclasses.replace(CFG, **change)
    ref = RefRenderer(scene_ref, cfg)
    port = Renderer(scene, cfg, device="cpu")
    assert (port.sampler, port.texture_dtype) == (ref.sampler, ref.texture_dtype)
    assert port._frame_kwargs["texture_format"] == ref._frame_kwargs["texture_format"]
    texels = port.scene["atlas"].get("texels")
    if port.sampler == "window":
        assert texels is None
    else:
        want = np.asarray(ref.scene["atlas"]["texels"])
        assert texels.shape == want.shape and texels.element_size() == want.dtype.itemsize
        np.testing.assert_array_equal(texels.view(torch.uint8).numpy(), want.view(np.uint8))


def test_frame_uniforms_match_reference(scene_ref, cam, port):
    ref = RefRenderer(scene_ref, CFG)
    for a, b in zip(port.frame_uniforms(cam), ref.frame_uniforms(cam)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gbuf_output(port, cam):
    out = render_frame(port.scene, *port.frame_uniforms(cam), **dict(port._frame_kwargs, output="gbuf"))
    assert set(out) == {"gbuf", "depth", "fid"}
    g, fid = port.debug_gbuf(cam, with_fid=True)
    assert torch.equal(out["gbuf"], g) and torch.equal(out["fid"], fid)
    assert out["gbuf"].shape == (24, 128, 256) and fid.dtype == torch.int32
    assert torch.equal((fid >= 0).float(), g[16])


def test_render_to_host(port, cam):
    img = port.render_to_host(cam)
    assert img.shape == (128, 256, 4) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, np.moveaxis(port.render(cam)["color"].numpy(), 0, -1))


def test_recreate_swapchain_and_zero_extent_deferral(scene, cam):
    r = Renderer(scene, CFG, device="cpu")
    r.recreate_swapchain(0, 96)
    assert r.render(cam)["color"].shape == (4, 128, 256)
    r.recreate_swapchain(200, 0)
    assert (r.width, r.height) == (256, 128)
    r.recreate_swapchain(200, 96)
    out = r.render(cam)
    assert out["color"].shape == (4, 96, 200) and out["depth"].shape == (96, 200)
    fresh = Renderer(scene, dataclasses.replace(CFG, width=200, height=96), device="cpu").render(cam)
    assert torch.equal(out["color"], fresh["color"])


@pytest.mark.parametrize("change,item", [(dict(binning="scan"), "scan")])
def test_unported_config_raises(scene, change, item):
    with pytest.raises(NotImplementedError, match=item):
        Renderer(scene, dataclasses.replace(CFG, **change), device="cpu")


@pytest.mark.parametrize(
    "change,item",
    [
        (dict(tile_row_offset=0), "item 12"),
        (dict(crop_height=64), "item 12"),
    ],
)
def test_unported_frame_options_raise(port, cam, change, item):
    with pytest.raises(NotImplementedError, match=item):
        render_frame(port.scene, *port.frame_uniforms(cam), **dict(port._frame_kwargs, **change))


def test_renderer_runs_on_the_card_unless_asked_for_the_cpu():
    assert inspect.signature(Renderer).parameters["device"].default == "cuda"
