"""tpurast_torch Renderer end to end against the JAX reference (CPU).

chip_smoke.py's procedural scene, cut to 256x128 with a smaller floor,
fewer spheres and 128^2 textures, through tpurast.renderer.Renderer and
tpurast_torch.renderer.Renderer on the same camera: sRGB u8 color within
1 LSB, linear color within 1e-3 (largest measured: 8.7e-4; the reference
and the port sample the same bf16 page with differently rounded x
weights, see tpurast_torch/kernels/sampler.py), depth within 5 ulp
(largest measured: 4; XLA:CPU FMA contraction, tests/test_torch_raster.py),
same bin_overflow and window_miss_px. The row-atlas paths (gather,
deferred) and the sampler and texel-format choice are held in
tests/test_torch_renderer_gather.py on the same scene.

Also the Renderer surface: output="gbuf" and "linear", frame_uniforms,
render_to_host, the zero-extent recreate_swapchain, and binning="scan":
the pairs frame bit for bit, and with a pair buffer that truncates, the
truncated pairs counted in bin_overflow. The runtime (stage= prefixes,
Engine, Presenter, the bench) is held in tests/test_torch_runtime.py,
slabs in tests/test_torch_parallel.py.

Time on one worker: about 80 s, most of it the reference's two
interpret-mode frames and the plain raster.
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


@pytest.mark.parametrize("truncate", [False, True], ids=["fits", "truncated"])
def test_scan_binning(scene, cam, port, truncate):
    """binning="scan" (geometry.bin_triangles) renders the pairs frame bit
    for bit; a pair buffer of half the frame's pairs counts the rest in
    bin_overflow, and the frame still renders."""
    from tpurast_torch.kernels import geometry

    kw = port._frame_kwargs
    vp, cp = port.frame_uniforms(cam)
    so = geometry.triangle_setup(geometry.transform_corners(port.scene["corner_world"], vp), None,
                                 port.scene["n_faces"], kw["width"], kw["height"])
    n_pairs = int(geometry.bin_pairs(so["aabb"], so["valid"], port.tiles_x, port.tiles_y, kw["tile_w"],
                                     kw["tile_h"])["offsets"][-1])
    cap = n_pairs // 2 if truncate else None
    scan = Renderer(scene, dataclasses.replace(CFG, binning="scan", bin_capacity=cap), device="cpu")
    want_cap = -(-cap // 128) * 128 if truncate else max(4 * scene.faces.shape[0], 16384)
    assert scan.binning == "scan" and scan.bin_capacity == want_cap
    got, want = scan.render(cam), port.render(cam)
    assert int(got["bin_overflow"]) == (max(n_pairs - scan.bin_capacity, 0) if truncate else 0)
    if truncate:
        assert int(got["bin_overflow"]) > 0 and not torch.equal(got["depth"], want["depth"])
        assert float((got["depth"] > 0).float().mean()) > 0.01
    else:
        assert torch.equal(got["color"], want["color"]) and torch.equal(got["depth"], want["depth"])


def test_renderer_runs_on_the_card_unless_asked_for_the_cpu():
    assert inspect.signature(Renderer).parameters["device"].default == "cuda"
