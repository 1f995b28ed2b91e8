"""tpurast_torch stands alone: no import of the JAX package, and its copies
of the reference's host modules agree with the originals.

  * a fresh interpreter in which ``tpurast`` cannot be imported imports
    every module of tpurast_torch (pkgutil.walk_packages) and
    chip_smoke.py, and ends with neither tpurast nor jax loaded;
  * no file under tpurast_torch/, nor chip_smoke.py, names tpurast or jax
    in an import statement or in an importlib / __import__ call (AST), nor
    zstandard, apart from the writer assets/ktx2_write.py (the port reads
    supercompressed KTX2 with its own decoder, assets/zstd.py);
  * copy parity, exact: RendererConfig's fields and defaults; every public
    math3d function and Camera.view_matrix on seeded inputs; parse_ktx2
    of generated KTX2 files; the BC4, BC6H (unsigned, signed) and BC7
    decoders, numpy and native, on seeded random blocks (the reference
    decodes no BC1, BC3, BC5 or signed BC4, so neither package does);
    build_atlas, fallback_texture and build_pages field for field;
    interleave; and the runtime's copies: replicate_model and _quad_draw
    draw for draw, FrameStats' and Engine's constants, the stage order of
    profiling, and the bench's command line (every option of the
    reference's, with its default, plus the port's own). The named-scene
    loaders read the reference's data directory and are held to their
    originals where it is mounted (tests/test_torch_runtime.py).
"""

import ast
import dataclasses
import inspect
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from tpurast import camera as ref_camera
from tpurast import cli as ref_cli
from tpurast import config as ref_config
from tpurast import engine as ref_engine
from tpurast import math3d as ref_math3d
from tpurast import overlay as ref_overlay
from tpurast import present as ref_present
from tpurast import profiling as ref_profiling
from tpurast.assets import gltf as ref_gltf
from tpurast.assets import bcdec as ref_bcdec
from tpurast.assets import ktx2 as ref_ktx2
from tpurast.assets import ktx2_write as ref_ktx2_write
from tpurast.device import pages as ref_pages
from tpurast.device import scene as ref_scene
from tpurast.device import textures as ref_textures
from tpurast_torch import camera, cli, config, engine, math3d, overlay, profiling
from tpurast_torch import present as runtime_present
from tpurast_torch.assets import bcdec, gltf, ktx2, ktx2_write, native
from tpurast_torch.device import pages, scene, textures
from tpurast_torch.kernels import present

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("tpurast", "jax")
# zstandard is the writer's alone: every reader uses the port's decoder.
ZSTANDARD_ALLOWED = {"tpurast_torch/assets/ktx2_write.py"}

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["tpurast"] = None  # any import of the reference package fails
sys.path.insert(0, sys.argv[1])
import tpurast_torch
names = [m.name for m in pkgutil.walk_packages(tpurast_torch.__path__, "tpurast_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("tpurast", "jax") and sys.modules[m] is not None)
assert not loaded, loaded
print(" ".join(names))
"""

# Modules the runtime slice added, then slabs, charts, the analysis tools,
# and the data path (the decoder, the writers, the stand-in data, entry);
# the walk must reach each of them.
RUNTIME_MODULES = {"cli", "engine", "present", "overlay", "profiling", "device.scene_cache", "parallel",
                   "device.charts", "entry", "assets.zstd", "assets.glb_write"} | {f"tools.{t}" for t in (
                       "profile_stages", "sample_stage_probe", "profile_sampler", "sampler_plan_stats",
                       "check_sampler", "aniso_mode_stats", "residual_analysis", "sampler_sim", "standin_data")}


def test_port_imports_without_the_reference_package():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, str(REPO)], capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, cwd=REPO / "tests",
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    walked = set(proc.stdout.split())
    assert len(walked) >= 42  # every module was walked
    assert {f"tpurast_torch.{m}" for m in RUNTIME_MODULES} <= walked


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imports(path: pathlib.Path) -> list[str]:
    """Every module name an import statement, importlib.import_module or
    __import__ call in the file names."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif isinstance(node, ast.Call):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if called in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                names.append(arg.value if isinstance(arg, ast.Constant) else "<computed>")
    return names


# The port's sources; tpurast_torch/_build/ holds build output (gitignored).
PORT_FILES = sorted(p for p in (REPO / "tpurast_torch").rglob("*.py") if "_build" not in p.parts) + [
    REPO / "chip_smoke.py"
]


def test_no_file_of_the_port_imports_tpurast_or_jax():
    assert len(PORT_FILES) >= 42
    assert {m.replace(".", "/") + ".py" for m in RUNTIME_MODULES} <= {
        str(p.relative_to(REPO / "tpurast_torch")) for p in PORT_FILES[:-1]}
    bad = {str(p.relative_to(REPO)): n for p in PORT_FILES for n in _imports(p) if _forbidden(n) or n == "<computed>"}
    assert not bad, bad
    zstd_users = {str(p.relative_to(REPO)) for p in PORT_FILES if any(n.split(".")[0] == "zstandard" for n in _imports(p))}
    assert zstd_users <= ZSTANDARD_ALLOWED, zstd_users


def test_the_ast_check_sees_every_form_of_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax.numpy as jnp\nfrom tpurast.device import scene\n"
                   "def f():\n    import importlib\n    importlib.import_module('tpurast.config')\n"
                   "    __import__('jax')\n")
    assert [n for n in _imports(src) if _forbidden(n)] == ["jax.numpy", "tpurast.device", "tpurast.config", "jax"]


# ---------------------------------------------------------------------------
# Copy parity.


def test_renderer_config_fields_and_defaults_match():
    port, ref = dataclasses.fields(config.RendererConfig), dataclasses.fields(ref_config.RendererConfig)
    assert [(f.name, f.type) for f in port] == [(f.name, f.type) for f in ref]
    assert dataclasses.asdict(config.RendererConfig()) == dataclasses.asdict(ref_config.RendererConfig())
    assert config.RendererConfig().vfov == ref_config.RendererConfig().vfov


def _mat(rng):
    return rng.normal(size=(4, 4)).astype(np.float32)


def _vec(rng, n=3):
    return rng.normal(size=n).astype(np.float32)


def _quat(rng):
    q = rng.normal(size=4).astype(np.float32)
    return q / np.linalg.norm(q)


MATH3D_CASES = {
    "coordinate_transform": lambda m, rng: (m.BLENDER, m.VULKAN),
    "mat4_identity": lambda m, rng: (),
    "compose": lambda m, rng: (_mat(rng), _mat(rng), _mat(rng)),
    "translation": lambda m, rng: (_vec(rng),),
    "scaling": lambda m, rng: (_vec(rng),),
    "rotation_quat": lambda m, rng: (_quat(rng),),
    "rotation_axis": lambda m, rng: (float(rng.uniform(-3, 3)), _vec(rng)),
    "trs": lambda m, rng: (_vec(rng), _quat(rng), _vec(rng)),
    "normalize": lambda m, rng: (_vec(rng),),
    "cross": lambda m, rng: (_vec(rng), _vec(rng)),
    "forward_from_euler": lambda m, rng: (float(rng.uniform(-1.5, 1.5)), float(rng.uniform(-3, 3))),
    "look_at": lambda m, rng: (_vec(rng), _vec(rng), np.array([0.0, -1.0, 0.0], np.float32)),
    "perspective_inverse_depth": lambda m, rng: (float(rng.uniform(0.5, 2.0)), 16 / 9, 0.01),
    "normal_matrix": lambda m, rng: (_mat(rng),),
    "transform_point": lambda m, rng: (_mat(rng), _vec(rng)),
    "transform_direction": lambda m, rng: (_mat(rng), _vec(rng)),
}


def test_math3d_cases_cover_every_public_function():
    public = {n for n, f in inspect.getmembers(ref_math3d, inspect.isfunction)
              if not n.startswith("_") and f.__module__ == ref_math3d.__name__}
    assert public == set(MATH3D_CASES)


@pytest.mark.parametrize("name", sorted(MATH3D_CASES))
def test_math3d_matches_reference(name):
    for seed in range(5):
        got = getattr(math3d, name)(*MATH3D_CASES[name](math3d, np.random.default_rng(seed)))
        want = getattr(ref_math3d, name)(*MATH3D_CASES[name](ref_math3d, np.random.default_rng(seed)))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_camera_view_matrix_matches_reference():
    rng = np.random.default_rng(5)
    for _ in range(20):
        pos, target = rng.normal(size=3) * 5, rng.normal(size=3)
        got = camera.Camera.from_target(pos, target)
        want = ref_camera.Camera.from_target(pos, target)
        assert (got.pitch, got.yaw) == (want.pitch, want.yaw)
        np.testing.assert_array_equal(got.view_matrix(), want.view_matrix())
        turned = got.update_orientation(3.0, -2.0)
        np.testing.assert_array_equal(turned.view_matrix(), want.update_orientation(3.0, -2.0).view_matrix())


def _blocks(fmt: str, n: int = 512) -> np.ndarray:
    width = 8 if fmt == "bc4" else 16
    return np.random.default_rng(len(fmt)).integers(0, 256, (n, width), dtype=np.uint8)


DECODES = {
    "bc4": lambda m, b: m.decode_bc4(b),
    "bc6h_uf": lambda m, b: m.decode_bc6h(b),
    "bc6h_sf": lambda m, b: m.decode_bc6h(b, signed=True),
    "bc7": lambda m, b: m.decode_bc7(b),
}


@pytest.mark.parametrize("fmt", sorted(DECODES))
def test_bc_decoders_match_reference(fmt):
    blocks = _blocks(fmt.split("_")[0])
    want = DECODES[fmt](ref_bcdec, blocks)
    np.testing.assert_array_equal(DECODES[fmt](bcdec, blocks), want)
    if not native.available():
        pytest.skip("no host C++ compiler for the port's native BC decoder")
    np.testing.assert_array_equal(DECODES[fmt](native, blocks), want)


def test_native_decoder_builds_into_the_port():
    if not native.available():
        pytest.skip("no host C++ compiler for the port's native BC decoder")
    assert native._LIB.parent == REPO / "tpurast_torch" / "_build"
    assert not list(native._LIB.parent.glob("*.tmp"))


@pytest.mark.parametrize("vk_format", sorted(ref_ktx2.BLOCK_FORMATS))
def test_parse_ktx2_matches_reference(vk_format):
    rng = np.random.default_rng(vk_format)
    block = 8 if vk_format == ref_ktx2.VK_FORMAT_BC4_UNORM_BLOCK else 16
    sizes = [(16, 8), (8, 4), (4, 2), (2, 1), (1, 1)]
    payloads = [rng.integers(0, 256, max(1, -(-w // 4)) * max(1, -(-h // 4)) * block, dtype=np.uint8).tobytes()
                for w, h in sizes]
    blob = ref_ktx2_write.write_ktx2(payloads, vk_format, 16, 8, supercompress=False)
    assert ktx2_write.write_ktx2(payloads, vk_format, 16, 8, supercompress=False) == blob
    got, want = ktx2.parse_ktx2(blob), ref_ktx2.parse_ktx2(blob)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "levels":
            assert [dataclasses.asdict(x) for x in a] == [dataclasses.asdict(x) for x in b]
        else:
            assert a == b, f.name
    for attr in ("format_name", "is_srgb"):
        assert getattr(got, attr) == getattr(want, attr)


def _pyramids():
    rng = np.random.default_rng(9)
    mips = textures.mip_chain(rng.uniform(0, 1, (32, 32, 4)).astype(np.float32))
    return [textures.fallback_texture(), mips, [rng.uniform(0, 1, (8, 8, 4)).astype(np.float32)]]


@pytest.mark.parametrize("what", ["build_atlas", "build_pages", "fallback_texture"])
def test_atlas_and_pages_match_reference(what):
    pyr = _pyramids()
    if what == "fallback_texture":
        for a, b in zip(textures.fallback_texture(), ref_textures.fallback_texture(), strict=True):
            np.testing.assert_array_equal(a, b)
        return
    port, ref = (textures.build_atlas, ref_textures.build_atlas) if what == "build_atlas" else (
        pages.build_pages, ref_pages.build_pages)
    got, want = port(pyr), ref(pyr)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)


@pytest.mark.parametrize("shape", [(4, 6, 10), (3, 6, 10), (6, 10)], ids=["planar", "three_planes", "2d"])
def test_interleave_matches_reference(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got, want = present.interleave(img), ref_present.interleave(img)
    assert got.flags["C_CONTIGUOUS"] == want.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    assert runtime_present.interleave is present.interleave  # one definition


def _draws_equal(got, want):
    assert len(got.draws) == len(want.draws) and got.image_uris == want.image_uris
    for a, b in zip(got.draws, want.draws):
        assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


@pytest.mark.parametrize("normal_up", [True, False])
def test_quad_draw_and_replicate_model_match_reference(normal_up):
    rng = np.random.default_rng(11)
    args = ((0.5, -1.0), 8.0, 6.0, 1.8, 8.0, "mem://quad.ktx2")
    quad, ref_quad = scene._quad_draw(*args, normal_up=normal_up), ref_scene._quad_draw(*args, normal_up=normal_up)
    model = gltf.GltfModel(draws=[quad], image_uris=["mem://quad.ktx2"])
    ref_model = ref_gltf.GltfModel(draws=[ref_quad], image_uris=["mem://quad.ktx2"])
    _draws_equal(model, ref_model)
    transforms = [math3d.trs(_vec(rng), _quat(rng), np.abs(_vec(rng)) + 0.5) for _ in range(5)]
    _draws_equal(scene.replicate_model(model, transforms), ref_scene.replicate_model(ref_model, transforms))


def test_frametime_overlay_matches_reference():
    pytest.importorskip("PIL")
    frame = np.random.default_rng(2).integers(0, 256, (48, 320, 4), dtype=np.uint8)
    got, want = overlay.draw_frametime_overlay(frame, 1.33230), ref_overlay.draw_frametime_overlay(frame, 1.33230)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got != frame).any() and (got[40:] == frame[40:]).all()  # a box at the top, nothing below it


def test_runtime_constants_match_reference():
    assert profiling.STAGES == ref_profiling.STAGES
    assert engine.Engine.MAX_TIMESTEP == ref_engine.Engine.MAX_TIMESTEP
    assert inspect.signature(overlay.FrameStats).parameters["window"].default == \
        inspect.signature(ref_overlay.FrameStats).parameters["window"].default
    ref_tick, tick = inspect.signature(ref_engine.Engine.tick), inspect.signature(engine.Engine.tick)
    assert list(tick.parameters) == list(ref_tick.parameters)
    assert list(inspect.signature(engine.Engine.run).parameters) == list(
        inspect.signature(ref_engine.Engine.run).parameters)
    assert list(inspect.signature(profiling.stage_sweep).parameters)[:4] == list(
        inspect.signature(ref_profiling.stage_sweep).parameters)


def test_bench_command_line_keeps_the_reference_options():
    def options(parser):
        return {a.dest: a for a in parser._actions if a.dest != "help"}

    port, ref = options(cli._build_parser()), options(ref_cli._build_parser())
    assert set(port) - set(ref) == {"device", "seed"}
    for dest, action in ref.items():
        assert port[dest].option_strings == action.option_strings
        if dest == "data_dir":
            assert port[dest].default is None  # no path of any machine in the port
        elif dest == "scene":
            assert port[dest].default == action.default
            assert set(port[dest].choices) == set(action.choices) | {"orbit"}
        else:
            assert (port[dest].default, port[dest].choices, port[dest].type) == (
                action.default, action.choices, action.type), dest
    assert port["device"].default == "cuda"
    assert [c for c in cli.ALL_CONFIGS if c[1] != "orbit_1080p"] == ref_cli.ALL_CONFIGS
