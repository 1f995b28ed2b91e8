"""tpurast_torch's row-atlas paths end to end against the JAX reference (CPU).

tests/test_torch_renderer.py's scene and camera (256x128): the
forward+gather frame (sampler="gather", f16 and srgb8 texels) and the
deferred frame (shading="deferred") within 1 LSB of the reference's,
depth within 5 ulp; the port's forward+gather frame equal to its deferred
frame bit for bit (the reference's invariant,
tests/test_pipeline.py:209-239), at max_anisotropy 16 and 4; a scene
without pages rendered through the gather sampler; the Renderer's
sampler, texture dtype and texel format chosen as the reference's are,
and the atlas rows uploaded only for the gather paths. At 512x256 the
same scene shows a reference fault: the windowed sampler's plan bands
miss texels of wrap-crossing footprints on mips at most 255 texels wide
(ROADMAP queue 3); the port follows the reference's gather path there.
On the CPU the gather and deferred wrappers run their plain versions
(kernels/shade.py); tests/test_torch_csrc.py holds the kernels.

Time on one worker: about 130 s, most of it the reference's five
interpret-mode frames.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpurast.renderer import Renderer as RefRenderer
from tpurast_torch.device.scene import orbit_track
from tpurast_torch.renderer import Renderer
from test_torch_raster import depth_ulps
from test_torch_renderer import CFG, cam, scene, scene_ref  # noqa: F401  (the module's fixtures)
from test_torch_scene import numpy_bc_decoders  # noqa: F401  (module-wide autouse)


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
