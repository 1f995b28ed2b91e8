"""tpurast_torch plan and sampler (plain versions of csrc/plan.cu and
csrc/sampler.cu) against the JAX reference, on the CPU.

The plan: the reference's plan_tiles and the port's, on the reference's
own G-buffer, must agree value for value (class, slot count, window
origins, per-chunk plan words and probe counts, per-pixel own/parent
slots, residual pixel count).

The frame: the reference samples through its windowed kernel (planned
VMEM windows, tent-weight matmuls) and sends tiles that need more than
32 windows to its gather fallback; the port's texels all come from the
same bf16 page. The final sRGB u8 frame must agree within 1 LSB per
channel (the reference's own budget between its two samplers), with the
same coverage, bin_overflow and window_miss_px, on:
  * the grazing checkered floor at max_anisotropy 16 (up to 16 probes);
  * tests/test_sampler_hard_paths.py's many-texture scenes: 18 textures
    in one tile (the reference's second kernel wave) and 40 (a residual
    tile, shaded by the reference's gather fallback).
Depth is held within 32 ulp (largest measured: 30, on the checker):
XLA:CPU contracts FMAs in the reference's interpret-mode raster kernel
(tests/test_torch_raster.py).
"""

import numpy as np
import pytest

import jax
import torch

from tpurast.camera import Camera
from tpurast.config import RendererConfig
from tpurast.kernels import sampler as ref_sampler
from tpurast.renderer import Renderer as RefRenderer
from tpurast_torch.device.scene import face_tables, from_numpy
from tpurast_torch.kernels import sampler
from tpurast_torch.renderer import Renderer
from test_sampler import _checker_scene
from test_torch_raster import depth_ulps
from test_sampler_hard_paths import _CAM as HARD_CAM
from test_sampler_hard_paths import _many_texture_scene
from test_torch_scene import numpy_bc_decoders  # noqa: F401  (module-wide autouse)

SCENES = {
    "checker_aniso16": lambda: (
        _checker_scene(),
        RendererConfig(width=128, height=64, segment_headroom=256),
        Camera.from_target([0.0, -0.12, -6.0], [0.0, -0.02, 2.0]),
    ),
    "second_wave_tile": lambda: (
        _many_texture_scene(18, cols=9, rows=2),
        RendererConfig(width=128, height=32, segment_headroom=128),
        HARD_CAM,
    ),
    "residual_tile": lambda: (
        _many_texture_scene(40, cols=10, rows=4),
        RendererConfig(width=128, height=32, segment_headroom=128),
        HARD_CAM,
    ),
}


@pytest.fixture(scope="module", params=list(SCENES))
def frames(request):
    scene, cfg, cam = SCENES[request.param]()
    ref_r = RefRenderer(scene, cfg)
    ref = ref_r.render(cam)
    port_r = Renderer(scene, cfg, device="cpu")
    port_r.scene = face_tables(from_numpy(jax.tree.map(np.asarray, ref_r.scene), "cpu"), ("resolve",))
    port = port_r.render(cam)
    g = ref_r.debug_gbuf(cam)
    kw = dict(tiles_x=ref_r.tiles_x, tiles_y=ref_r.tiles_y, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
              max_anisotropy=cfg.max_anisotropy)
    plans = (
        {k: np.asarray(v) for k, v in ref_sampler.plan_tiles(g, None, None, **kw).items()},
        sampler.plan_tiles(torch.from_numpy(np.array(g)), **kw),
        cfg.tile_h // sampler.rc_for(cfg.tile_h),
    )
    return (
        {k: np.asarray(v) for k, v in ref.items()},
        {k: v.numpy() for k, v in port.items()},
        request.param,
        plans,
    )


def test_plan_matches_reference(frames):
    ref, port, nc = frames[3]
    table = port["table"].numpy()
    np.testing.assert_array_equal(table[:, 0, 0], ref["cls"])
    np.testing.assert_array_equal(table[:, 0, 1], ref["n_used"])
    np.testing.assert_array_equal(table[:, 0, 32:64].reshape(-1), ref["slot_oy"])
    np.testing.assert_array_equal(table[:, 0, 64:96].reshape(-1), ref["slot_ox"])
    np.testing.assert_array_equal(table[:, 1 : 1 + nc, :32].reshape(-1), ref["chunk_pack"])
    np.testing.assert_array_equal(table[:, 1 : 1 + nc, sampler.CHUNK_NP_LANE].reshape(-1), ref["chunk_np"])
    np.testing.assert_array_equal(port["assign"].numpy(), ref["assign"])
    assert int(port["residual_px"]) == int(ref["residual_px"])


def test_color_within_one_lsb(frames):
    ref, port, *_ = frames
    assert port["color"].shape == ref["color"].shape and port["color"].dtype == np.uint8
    diff = np.abs(port["color"].astype(np.int32) - ref["color"].astype(np.int32))
    assert diff.max() <= 1, f"max {diff.max()} LSB at {(diff > 1).sum()} values"


def test_depth_and_coverage(frames):
    ref, port, *_ = frames
    covered = ref["depth"] > 0
    assert covered.mean() > 0.2
    np.testing.assert_array_equal(port["depth"] > 0, covered)
    assert depth_ulps(port["depth"], ref["depth"]).max() <= 32


def test_counters(frames):
    ref, port, name, _ = frames
    assert int(port["bin_overflow"]) == int(ref["bin_overflow"]) == 0
    # Pixels of residual tiles, which both sample outside the windows.
    assert int(port["window_miss_px"]) == int(ref["window_miss_px"])
    assert (int(ref["window_miss_px"]) > 0) == (name == "residual_tile")
