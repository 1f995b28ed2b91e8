"""The reference's data path on the stand-in data directory, on the CPU.

tpurast_torch.tools.standin_data writes a directory laid out as the
reference's data directory (GLB meshes, BC7 / BC6H KTX2 textures
supercompressed with Zstandard). At ``--scale small``:

  * the four named scenes (demo, hdr, porsche_class, dragons64) load
    through the port's load_named_scene and the reference's loaders into
    equal scenes: faces, the per-draw arrays, prim_tex, the atlas and the
    page planes, exactly (tests/test_torch_runtime.py's comparison; the
    reference inflates with zstandard, the port with its own decoder);
    the same directory written with stored frames gives the same scenes;
  * the dragon blob has the dragon's 19,332 triangles and 11,319 vertices
    at full scale, and is closed at both scales; the directory holds the
    marker and no porche.glb;
  * the atlas' quad rows are built on first read only: the window path
    and resolve_texture_dtype leave them unbuilt, a pickle round trip of
    the scene (the scene cache) carries none, and the gather path's rows
    equal the reference's eager build_atlas bit for bit;
  * entry(<stand-in>, device="cpu"): fn(*args) equals Renderer.render bit
    for bit, and its color is within 1 LSB of the reference's Renderer on
    the same directory and camera (the reference's interpret-mode frame is
    computed once per module).

Both packages decode BC blocks with their numpy decoders here
(test_torch_scene.numpy_bc_decoders): the reference's native build writes
its library in place, which parallel workers could race on.

Time on one worker: about 35 s, 20 s of it the reference's frame.
"""

from __future__ import annotations

import collections
import json
import pickle

import numpy as np
import pytest
import torch

from tpurast.camera import Camera as RefCamera
from tpurast.config import RendererConfig as RefConfig
from tpurast.renderer import Renderer as RefRenderer
from tpurast_torch.assets.gltf import load_glb
from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.device import scene_cache, textures
from tpurast_torch.device.scene import build_scene
from tpurast_torch.entry import EYE, HEIGHT, TARGET, WIDTH, entry
from tpurast_torch.kernels import present
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import standin_data
from test_torch_runtime import assert_named_scene_matches_reference
from test_torch_scene import numpy_bc_decoders  # noqa: F401  (module-wide autouse)

NAMES = ["demo", "hdr", "porsche_class", "dragons64"]


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The small stand-in, supercompressed with the zstandard package."""
    out = tmp_path_factory.mktemp("standin")
    standin_data.write_standin(out, "small", seed=0)
    return out


@pytest.fixture(scope="module")
def standin_stored(tmp_path_factory):
    """The same stand-in written by the command line with stored frames."""
    out = tmp_path_factory.mktemp("standin_stored")
    assert standin_data.main([str(out), "--scale", "small", "--stored"]) == 0
    return out


@pytest.fixture()
def no_cache(monkeypatch):
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE", "0")


@pytest.mark.parametrize("name", NAMES)
def test_named_scenes_match_the_reference(standin, standin_stored, name, no_cache):
    got = assert_named_scene_matches_reference(name, standin)
    stored = scene_cache.load_named_scene(name, str(standin_stored))
    np.testing.assert_array_equal(stored.pages.planes, got.pages.planes)
    np.testing.assert_array_equal(stored.atlas.texels, got.atlas.texels)


@pytest.mark.parametrize("scale", ["full", "small"])
def test_dragon_blob_counts_and_closed(scale):
    cfg = standin_data.SCALES[scale]
    pos, nrm, uvs, tris = standin_data.dragon_blob(cfg["bands"], cfg["segments"], cfg["splits"], seed=0)
    if scale == "full":
        assert (len(tris), len(pos)) == (19332, 11319)
    assert len(np.unique(tris)) == len(pos)  # every vertex is used
    # Closed: over positions, every directed edge meets its reverse once.
    _, geo = np.unique(pos, axis=0, return_inverse=True)
    g = geo.reshape(-1)[tris]
    edges = collections.Counter(zip(g.reshape(-1), np.roll(g, -1, axis=1).reshape(-1)))
    assert all(n == 1 and edges[(b, a)] == 1 for (a, b), n in edges.items())
    world = pos * np.array([-1.0, -1.0, 1.0])  # glTF model space to world
    centre = (world.min(0) + world.max(0)) / 2
    assert np.allclose(centre, [0.0, 0.05, 0.0], atol=0.02)
    assert 0.15 < float((world.max(0) - world.min(0)).max()) < 0.3
    assert np.allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-5)


def test_layout_and_marker(standin):
    record = json.loads((standin / "STANDIN.json").read_text())
    assert "not the reference's data" in record["note"] and record["scale"] == "small"
    assert len(list((standin / "textures" / "porche").glob("*.ktx2"))) == 10
    assert not (standin / "meshes" / "porche.glb").exists() and not (standin.parent / "resources").exists()
    assert not (standin / standin_data.DRAGON_TEXTURE).exists()
    dragon = load_glb(standin / "meshes" / "stanford_dragon.glb")
    assert dragon.draws[0].image_uri == standin_data.DRAGON_TEXTURE
    for mesh in ("arena", "crate", "stanford_dragon"):
        blob = (standin / "meshes" / f"{mesh}.glb").read_bytes()
        gltf = json.loads(blob[20 : 20 + int.from_bytes(blob[12:16], "little")])
        assert gltf["asset"]["generator"] == standin_data.GENERATOR
    for rel in record["files"]:
        assert (standin / rel).stat().st_size == record["files"][rel]


def test_quad_rows_are_built_on_first_read(standin, no_cache):
    scene = scene_cache.load_named_scene("porsche_class", str(standin))
    assert not scene.atlas.rows_built
    f16 = scene.atlas.texels_nbytes // 2
    assert textures.resolve_texture_dtype(scene, "auto") == "float16" and f16 > 0
    Renderer(scene, RendererConfig(width=64, height=32), device="cpu")  # the window path
    again = pickle.loads(pickle.dumps(scene))
    assert not scene.atlas.rows_built and not again.atlas.rows_built
    assert len(pickle.dumps(scene)) < scene.atlas.texels_nbytes  # the pickle holds pyramids, not rows
    gather = Renderer(scene, RendererConfig(width=64, height=32, sampler="gather"), device="cpu")
    assert scene.atlas.rows_built and gather.scene["atlas"]["texels"].dtype == torch.float16
    assert scene.atlas.texels.nbytes == scene.atlas.texels_nbytes
    # Built from the pickled pyramids too, the rows are the same bits (and
    # test_named_scenes_match_the_reference holds them to the reference's
    # eager build_atlas).
    np.testing.assert_array_equal(again.atlas.texels, scene.atlas.texels)


@pytest.fixture(scope="module")
def entry_frame(standin):
    fn, args = entry(str(standin), device="cpu")
    return fn(*args)


def test_entry_equals_renderer_render(standin, entry_frame):
    scene = build_scene([load_glb(standin / "meshes" / "stanford_dragon.glb")], data_dir=str(standin))
    want = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT), device="cpu").render(
        Camera.from_target(list(EYE), list(TARGET)))
    assert set(entry_frame) == set(want)
    for k, v in want.items():
        assert torch.equal(entry_frame[k], v), k
    assert float((entry_frame["depth"] > 0).float().mean()) > 0.02  # the dragon is in view


def test_entry_within_one_lsb_of_the_reference(standin, entry_frame):
    from tpurast.assets.gltf import load_glb as ref_load_glb
    from tpurast.device.scene import build_scene as ref_build_scene

    scene = ref_build_scene([ref_load_glb(standin / "meshes" / "stanford_dragon.glb")], data_dir=str(standin))
    ref = RefRenderer(scene, RefConfig(width=WIDTH, height=HEIGHT)).render_to_host(
        RefCamera.from_target(list(EYE), list(TARGET)))
    got = present.interleave(entry_frame["color"].numpy())
    assert int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()) <= 1
