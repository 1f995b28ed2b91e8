"""Tile shapes: the port against the JAX reference past the default 32x128.

The reference's RendererConfig takes any tile shape with tile_w a multiple
of 128 (tpurast/kernels/raster.py:359), tile_h a multiple of 8 and at most
7 chunks of rc_for(tile_h) rows (tpurast/kernels/sampler.py:155-168,
:471). On tests/test_torch_renderer.py's 256x128 orbit scene, camera 3,
at 64x128 and 40x128 (8-row chunks), 112x128 (7 chunks) and 16x1024 (a
tile wider than the frame), the port's plain path (CPU) gives the
reference's frame: sRGB u8 color within 1 LSB, depth within 5 ulp (XLA:CPU
FMA contraction, tests/test_torch_raster.py), the same face ids (the
reference's debug_gbuf; the port frame's own raster output), bin_overflow
and window_miss_px; plan_tiles_plain
gives the reference's plan_tiles on the reference's G-buffer exactly at
64x128 and 112x128. Where the reference refuses a shape (128x128: 8
chunks; 64x64: the lane width; 12x128: not a multiple of 8), the port
raises ValueError naming the rule, at Renderer construction, in
render_frame and in parallel.make_sharded_renderer, before any work; and
the port takes exactly the shapes the reference's rules take. At 64x128
and 112x128 two slabs (parallel.py) put together equal the port's frame.

Each reference frame is computed once per module (a jit and an
interpret-mode frame: 20-25 s each on an 8-core Xeon, and its debug_gbuf
about 3 s more). About 130 s on one worker there, most of it the
reference.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from tpurast.config import RendererConfig
from tpurast.kernels import sampler as ref_sampler
from tpurast.renderer import Renderer as RefRenderer
from tpurast_torch import parallel
from tpurast_torch.config import RendererConfig as PortConfig
from tpurast_torch.device.scene import build_orbit_scene, orbit_track, upload
from tpurast_torch.kernels import raster, sampler
from tpurast_torch.renderer import Renderer, check_tiles, render_frame
from test_torch_raster import depth_ulps
from test_torch_scene import numpy_bc_decoders, reference_scene  # noqa: F401  (module-wide autouse)

CFG = RendererConfig(width=256, height=128, segment_headroom=512)
SHAPES = {"64x128": (64, 128), "40x128": (40, 128), "112x128": (112, 128), "16x1024": (16, 1024)}
PLAN_SHAPES = ("64x128", "112x128")
# (tile_h, tile_w, the rule the port's message names) where the reference refuses.
REFUSED = {"128x128": (128, 128, "7 chunks"), "64x64": (64, 64, "lane width"), "12x128": (12, 128, "multiple of 8")}


@pytest.fixture(scope="module")
def scene():
    return build_orbit_scene(seed=0, floor_quads=64, spheres=4, rings=16, segments=16, tex_size=128, n_textures=4)


@pytest.fixture(scope="module")
def scene_ref(scene):
    return reference_scene(scene)


@pytest.fixture(scope="module")
def cam():
    return orbit_track(8)[3]


@pytest.fixture(scope="module")
def frames(scene, scene_ref, cam):
    """frames(shape): both packages' frame and face ids at one tile shape,
    and the reference's G-buffer, computed once per module; at PLAN_SHAPES
    also both plans of that G-buffer."""
    cache = {}

    def get(shape):
        if shape in cache:
            return cache[shape]
        th, tw = SHAPES[shape]
        cfg = dataclasses.replace(CFG, tile_h=th, tile_w=tw)
        ref_r = RefRenderer(scene_ref, cfg)
        ref = {k: np.asarray(v) for k, v in ref_r.render(cam).items()}
        ref_g, ref_fid = ref_r.debug_gbuf(cam, with_fid=True)
        port_r = Renderer(scene, PortConfig(**dataclasses.asdict(cfg)), device="cpu")
        vis, rasterize = [], raster.rasterize_tiles

        def keep_vis(*args, **kw):  # the frame's own raster output: its face ids
            vis.append(rasterize(*args, **kw))
            return vis[-1]

        with mock.patch.object(raster, "rasterize_tiles", keep_vis):
            port = {k: v.numpy() for k, v in port_r.render(cam).items()}
        port_fid = vis[0][1].to(torch.int32)
        plans = None
        if shape in PLAN_SHAPES:
            kw = dict(tiles_x=ref_r.tiles_x, tiles_y=ref_r.tiles_y, tile_h=th, tile_w=tw,
                      max_anisotropy=cfg.max_anisotropy)
            plans = ({k: np.asarray(v) for k, v in ref_sampler.plan_tiles(ref_g, None, None, **kw).items()},
                     sampler.plan_tiles_plain(torch.from_numpy(np.array(ref_g)), **kw), th // sampler.rc_for(th))
        cache[shape] = dict(ref=ref, port=port, ref_fid=np.asarray(ref_fid), port_fid=port_fid.numpy(), plans=plans,
                            padded=(port_r.tiles_y * th, port_r.tiles_x * tw), port_r=port_r)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", list(SHAPES))
def test_frame_matches_reference(frames, shape):
    f = frames(shape)
    ref, port = f["ref"], f["port"]
    assert port["color"].shape == ref["color"].shape == (4, 128, 256) and port["color"].dtype == np.uint8
    diff = np.abs(port["color"].astype(np.int32) - ref["color"].astype(np.int32))
    assert diff.max() <= 1, f"max {diff.max()} LSB at {(diff > 1).sum()} values"
    covered = ref["depth"] > 0
    assert 0.05 < covered.mean() < 0.95
    np.testing.assert_array_equal(port["depth"] > 0, covered)
    assert depth_ulps(port["depth"], ref["depth"]).max() <= 5
    assert int(port["bin_overflow"]) == int(ref["bin_overflow"])
    assert int(port["window_miss_px"]) == int(ref["window_miss_px"])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_face_ids_match_reference(frames, shape):
    f = frames(shape)
    ref_fid, port_fid = f["ref_fid"], f["port_fid"]
    assert port_fid.shape == ref_fid.shape == f["padded"]
    assert (ref_fid >= 0).sum() > 3000
    np.testing.assert_array_equal(port_fid, ref_fid)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_matches_reference(frames, shape):
    ref, port, nc = frames(shape)["plans"]
    table = port["table"].numpy()
    assert (ref["cls"] == ref_sampler.CLS_WINDOWED).sum() >= 1
    np.testing.assert_array_equal(table[:, 0, 0], ref["cls"])
    np.testing.assert_array_equal(table[:, 0, 1], ref["n_used"])
    np.testing.assert_array_equal(table[:, 0, 32:64].reshape(-1), ref["slot_oy"])
    np.testing.assert_array_equal(table[:, 0, 64:96].reshape(-1), ref["slot_ox"])
    np.testing.assert_array_equal(table[:, 1 : 1 + nc, :32].reshape(-1), ref["chunk_pack"])
    np.testing.assert_array_equal(table[:, 1 : 1 + nc, sampler.CHUNK_NP_LANE].reshape(-1), ref["chunk_np"])
    np.testing.assert_array_equal(port["assign"].numpy(), ref["assign"])
    assert int(port["residual_px"]) == int(ref["residual_px"])


@pytest.mark.parametrize("shape", ("64x128", "112x128"))
def test_slabs_equal_the_frame(frames, cam, shape):
    """parallel.py's slab rows at a tall tile: 2 slabs of one tile row
    each, put together, equal the port's frame bit for bit."""
    f = frames(shape)
    r = f["port_r"]
    fn = parallel.make_sharded_renderer(r.scene, r.config, 2, 256, 128)
    out = fn(r.scene, *r.frame_uniforms(cam))
    for k in ("color", "depth", "bin_overflow", "window_miss_px"):
        np.testing.assert_array_equal(out[k].numpy(), f["port"][k])


@pytest.mark.parametrize("shape", list(REFUSED))
def test_port_refuses_where_reference_refuses(scene, scene_ref, cam, shape):
    th, tw, rule = REFUSED[shape]
    cfg = dataclasses.replace(CFG, tile_h=th, tile_w=tw)
    with pytest.raises((AssertionError, ValueError)):
        np.asarray(RefRenderer(scene_ref, cfg).render(cam)["color"])
    port_cfg = PortConfig(**dataclasses.asdict(cfg))
    with pytest.raises(ValueError, match=rule):
        Renderer(scene, port_cfg, device="cpu")
    sc = upload(scene, "cpu")
    with pytest.raises(ValueError, match=rule):
        parallel.make_sharded_renderer(sc, port_cfg, 2, 256, 128)
    r = Renderer(scene, PortConfig(width=256, height=128), device="cpu")
    kw = dict(r._frame_kwargs, tile_h=th, tile_w=tw, tiles_x=-(-256 // tw), tiles_y=-(-128 // th))
    with pytest.raises(ValueError, match=rule):
        render_frame(r.scene, *r.frame_uniforms(cam), **kw)


def test_port_takes_exactly_the_reference_shapes():
    """check_tiles accepts a shape where the reference's three rules hold
    (its own rc_for decides the chunks) and raises ValueError elsewhere."""
    for th in range(4, 161, 4):
        for tw in (64, 128, 192, 256, 384, 1024, 3840):
            try:
                ok = tw % 128 == 0 and th // ref_sampler.rc_for(th) <= 7
            except ValueError:
                ok = False
            if ok:
                check_tiles(th, tw)
            else:
                with pytest.raises(ValueError):
                    check_tiles(th, tw)
