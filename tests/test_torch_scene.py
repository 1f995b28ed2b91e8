"""tpurast_torch host side: page and scene build, upload, and no JAX.

  * device.pages.build_pages and device.scene.build_scene against the
    reference's, field for field (the port keeps its own copies of the
    reference's host modules);
  * upload(scene) against np.asarray of the reference's scene.device()
    leaves, the bf16 page bit for bit (torch's round to nearest even
    against ml_dtypes');
  * a fresh interpreter with jax, jaxlib, zstandard, ml_dtypes and the
    reference package blocked imports tpurast_torch, builds a procedural
    scene and renders a frame;
  * the kernel build and dispatch fail loudly instead of falling back.

Every test_torch_* module imports this one; it sets torch's threads per
pytest-xdist worker (below). Time on one worker: about 6 s.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpurast.device import pages as ref_pages
from tpurast.device import scene as ref_scene
from tpurast_torch import kernels
from tpurast_torch.device import pages, scene
from tpurast_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# torch's CPU operations get each pytest-xdist worker's share of the cores
# (one thread where 6 workers share 8 cores; all of them in a single
# process). With every worker's OpenMP team as wide as the machine, each
# operation's barrier waits for threads that the other workers have
# descheduled: on 8 cores with 6 workers the tier-1 command (ROADMAP.md)
# took 1,271 s with torch's default threads and 407 s with this. Every
# worker imports this module when it collects the suite.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))


@pytest.fixture(scope="module", autouse=True)
def numpy_bc_decoders():
    """Decode BC textures with the numpy decoders in the port's tests.

    The port's scenes decode through tpurast_torch.assets.native, whose
    build is safe under parallel workers (a temporary file moved into
    place), but the modules that import this fixture also build the
    reference's scenes, and tpurast.assets.native writes its library in
    place, so a parallel worker could load a half-written file. Both
    decoders give the same texels, and a module that compares the port
    with the reference decodes for both with the same one: the numpy
    decoders (TPURAST_NATIVE=0 turns the native one off in both
    packages). The decoders' state is restored afterwards."""
    from tpurast.assets import native as ref_native
    from tpurast_torch.assets import native

    mods = (native, ref_native)
    saved = (os.environ.get("TPURAST_NATIVE"), [(m._lib, m._tried) for m in mods])
    os.environ["TPURAST_NATIVE"] = "0"
    for m in mods:
        m._lib, m._tried = None, False
    yield
    env, states = saved
    for m, (lib, tried) in zip(mods, states):
        m._lib, m._tried = lib, tried
    if env is None:
        os.environ.pop("TPURAST_NATIVE", None)
    else:
        os.environ["TPURAST_NATIVE"] = env


def reference_scene(scene):
    """A DeviceScene of either package as the reference's own record, so
    that the JAX package can upload and render a scene the port built: the
    fields are the same; the atlas and pages become the reference's
    records (the port's copies have no jax upload)."""
    if isinstance(scene, ref_scene.DeviceScene):
        return scene
    from tpurast.device.pages import TexturePages
    from tpurast.device.textures import TextureAtlas

    fields = {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}
    fields["atlas"] = TextureAtlas(**{f.name: getattr(scene.atlas, f.name) for f in dataclasses.fields(scene.atlas)})
    if scene.pages is not None:
        fields["pages"] = TexturePages(**{f.name: getattr(scene.pages, f.name)
                                          for f in dataclasses.fields(scene.pages)})
    return ref_scene.DeviceScene(**fields)


def _toy_pyramids():
    """tests/test_sampler.py _toy_pages' pyramids."""
    rng = np.random.default_rng(7)
    mips = [
        rng.uniform(0, 1, (8, 16, 4)).astype(np.float32),
        rng.uniform(0, 1, (4, 8, 4)).astype(np.float32),
        rng.uniform(0, 1, (2, 4, 4)).astype(np.float32),
    ]
    small = [rng.uniform(0, 1, (4, 4, 4)).astype(np.float32)]
    return [mips, small]


def _big_pyramids():
    """A mip wider and taller than a sampler window (WRAP_GHOST borders)."""
    rng = np.random.default_rng(3)
    return [[rng.uniform(0, 1, (128, 512, 4)).astype(np.float32),
             rng.uniform(0, 1, (64, 256, 4)).astype(np.float32)]]


def _checker_models():
    """tests/test_sampler.py _checker_scene's model and assets."""
    from tpurast.assets.gltf import GltfModel
    from tpurast.assets.ktx2_write import make_bc4_ktx2

    y, x = np.mgrid[0:256, 0:256]
    checker = ((((x // 16) + (y // 16)) % 2) * 195 + 30).astype(np.uint8)
    floor = GltfModel(
        draws=[ref_scene._quad_draw((0.0, 0.0), 16.0, 16.0, 0.0, 16.0, "mem://checker.ktx2")],
        image_uris=["mem://checker.ktx2"],
    )
    return [floor], {"mem://checker.ktx2": make_bc4_ktx2(checker)}


def _assert_same_pages(a, b):
    for f in ("planes", "origins", "sizes", "n_mips"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("pyramids", [_toy_pyramids, _big_pyramids], ids=["toy", "wrap_ghost"])
def test_build_pages_matches_reference(pyramids):
    tex = pyramids()
    _assert_same_pages(pages.build_pages(tex), ref_pages.build_pages(tex))


def test_wrap_constants_match_reference():
    from tpurast.kernels import sampler as ref_sampler
    from tpurast_torch.kernels import sampler

    for name in ("WRAP_GHOST", "X_WRAP_LIM", "Y_WRAP_LIM"):
        assert getattr(sampler, name) == getattr(ref_sampler, name)


@pytest.fixture(scope="module")
def checker_scenes():
    models, assets = _checker_models()
    return (
        scene.build_scene(models, memory_assets=assets),
        ref_scene.build_scene(models, memory_assets=assets),
    )


def test_build_scene_matches_reference(checker_scenes):
    port, ref = checker_scenes
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    for field in dataclasses.fields(ref):
        a, b = getattr(port, field.name), getattr(ref, field.name)
        if field.name == "pages":
            _assert_same_pages(a, b)
        elif field.name == "atlas":
            for f in dataclasses.fields(b):
                np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


def test_upload_matches_reference_device_tree(checker_scenes):
    port_scene, ref = checker_scenes
    up = scene.upload(port_scene, "cpu")
    tree = jax.tree.map(np.asarray, ref.device())
    for k in ("corner_world", "corner_normal", "corner_uv", "face_tex"):
        np.testing.assert_array_equal(up[k].numpy(), tree[k], err_msg=k)
    assert up["n_faces"] == int(tree["n_faces"])
    for k in ("offsets", "sizes", "n_mips", "page_origins", "page_sizes", "page_n_mips"):
        np.testing.assert_array_equal(up["atlas"][k].numpy(), tree["atlas"][k], err_msg=k)
    page = up["atlas"]["page"]
    assert page.dtype == torch.bfloat16
    np.testing.assert_array_equal(page.view(torch.int16).numpy(), tree["atlas"]["page"].view(np.int16))
    assert "texels" not in up["atlas"]
    # from_numpy takes the same state from the reference's own tree.
    again = scene.from_numpy(tree, "cpu")
    assert torch.equal(again["atlas"]["page"].view(torch.int16), page.view(torch.int16))
    assert torch.equal(again["corner_world"], up["corner_world"])


def test_uploaded_page_is_one_interleaved_array(checker_scenes):
    """upload keeps one channel-interleaved (PH, PW, 4) copy of the page and
    hands out its (4, PH, PW) view: equal, bit for bit, to build_pages'
    planes rounded to bf16, accepted by the sample kernel's wrapper check
    where a planar copy is refused, and read by the plain sampler exactly
    like a contiguous planar copy."""
    from tpurast_torch.config import RendererConfig
    from tpurast_torch.kernels import sampler
    from tpurast_torch.renderer import Renderer

    port_scene, _ = checker_scenes
    r = Renderer(port_scene, RendererConfig(width=128, height=64), device="cpu")
    page = r.scene["atlas"]["page"]
    planes = torch.from_numpy(port_scene.pages.planes).to(torch.bfloat16)
    _, ph, pw = planes.shape
    assert tuple(page.shape) == (4, ph, pw) and page.stride() == (1, 4 * pw, 4)
    assert torch.equal(page.view(torch.int16), planes.view(torch.int16))
    base = page.permute(1, 2, 0)
    assert base.is_contiguous() and base.data_ptr() == page.data_ptr()
    assert torch.equal(sampler.interleave_page(planes).view(torch.int16), planes.view(torch.int16))
    sampler._check_page(page)
    for bad in (planes, page.to(torch.float16), page[:, :, :-1], page[:3]):
        with pytest.raises((TypeError, ValueError)):
            sampler._check_page(bad)

    from tpurast_torch.camera import Camera

    cam = Camera.from_target([0.0, -0.12, -6.0], [0.0, -0.02, 2.0])
    g = r.debug_gbuf(cam)
    _, cp = r.frame_uniforms(cam)
    kw = r._frame_kwargs
    tiles = dict(tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"])
    light = {k: kw[k] for k in ("light_direction", "light_color", "ambient_amount", "specular_power",
                                "clear_color", "blend")}
    plan = sampler.plan_tiles(g, max_anisotropy=16, **tiles)
    on_view = sampler.sample_tiles(g, page, plan, cp, max_anisotropy=16, **tiles, **light)
    on_planes = sampler.sample_tiles(g, planes.contiguous(), plan, cp, max_anisotropy=16, **tiles, **light)
    assert int((g[16] > 0).sum()) > 1000
    assert torch.equal(on_view, on_planes)


def test_bf16_round_to_nearest_even_matches_ml_dtypes():
    import ml_dtypes

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    ties = (np.arange(1, 5000, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    x = np.concatenate([x, ties, ties * -1.0]).astype(np.float32)
    port = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(port, x.astype(ml_dtypes.bfloat16).view(np.int16))


_NO_JAX = r"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "zstandard", "ml_dtypes", "tpurast")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this test")
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.renderer import Renderer
scene = build_orbit_scene(seed=1, floor_quads=16, spheres=2, rings=8, segments=8, tex_size=32, n_textures=2)
r = Renderer(scene, RendererConfig(width=128, height=64), device="cpu")
out = r.render(orbit_track(2)[1])
assert tuple(out["color"].shape) == (4, 64, 128)
assert int(out["bin_overflow"]) == 0
assert bool((out["depth"] > 0).any())
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("rendered", int((out["depth"] > 0).sum()))
"""


def test_port_runs_without_jax_zstandard_ml_dtypes():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, REPO], capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("rendered ")
    assert int(proc.stdout.split()[1]) > 100


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_dispatch_runs_plain_on_cpu_and_refuses_other_devices():
    cpu = torch.zeros(2)
    assert kernels.use_kernel(cpu, cpu) is False
    with pytest.raises(ValueError):
        kernels.use_kernel(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        kernels.use_kernel(torch.zeros(2, device="meta"))
