"""The port's runtime and bench entry point on the CPU, at small sizes.

The 256x128 orbit scene of tests/test_torch_renderer.py, device="cpu" (the
kernels' plain torch versions):

  * render_frame(stage=...) for each of the six prefixes returns the f32
    sum of the port's own stage outputs (the stages run one by one here),
    exactly; for "geometry" and "raster" it is within rtol 2e-6 of the
    reference's render_frame(stage=...) on the same scene (measured
    relative differences 2.3e-7 and 6.9e-8: the sums run over 1e5-1e6 f32 terms
    in another order, and depth carries the few ulps of the reference's
    FMA contraction); "segments" equals "binning"; a stage that the
    configured path does not have, and an unknown name, raise ValueError;
  * Presenter on CPU tensors and numpy arrays: None, then frame n-1,
    flush, a shape change between frames;
  * Engine: the reference's tests/test_pipeline.py engine case on the port,
    and its final frame within 1 LSB of the JAX Engine's on the same scene
    and config with overlay=False under a controller that only turns the
    camera (translation scales with wall-clock dt, which no two runs
    share); the one-frame-late counters of an untraced Engine, resize,
    the vsync cap;
  * FrameStats against the reference's on the same samples;
  * stage_sweep returns the reference's keys in order, delta summing to
    cum["frame"], and skips plan / sample on the gather path;
  * cli.main --device cpu --scene orbit at 128x64 (the procedural scene cut
    small): one JSON line with the bench's fields, parity_max_lsb 0 (both
    sides plain on the CPU), exit 0, also with --binning scan; without a
    CUDA device and without --device cpu, and with a missing data
    directory: non-zero, no line;
  * load_named_scene("orbit") cached and uncached give equal arrays; the
    loaders that read the reference's data directory skip without it.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from tpurast.camera import MoveDirection as RefMoveDirection
from tpurast.config import RendererConfig
from tpurast.engine import Engine as RefEngine
from tpurast.overlay import FrameStats as RefFrameStats
from tpurast.profiling import STAGES as REF_STAGES
from tpurast.renderer import Renderer as RefRenderer
from tpurast.renderer import render_frame as ref_render_frame
from tpurast_torch import cli, kernels, profiling
from tpurast_torch.camera import MoveDirection
from tpurast_torch.device import scene as scene_mod
from tpurast_torch.device import scene_cache
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.engine import Engine
from tpurast_torch.kernels import geometry, raster, resolve, sampler
from tpurast_torch.overlay import FrameStats
from tpurast_torch.present import Presenter
from tpurast_torch.renderer import STAGE_PREFIXES, Renderer, render_frame
from test_torch_scene import numpy_bc_decoders, reference_scene  # noqa: F401  (module-wide autouse)

CFG = RendererConfig(width=256, height=128, segment_headroom=512)
SMALL = dict(floor_quads=64, spheres=4, rings=16, segments=16, tex_size=128, n_textures=4)
# A scene the plain raster renders in a fraction of a second, for the loops.
TINY = dict(floor_quads=8, spheres=1, rings=8, segments=8, tex_size=32, n_textures=2)
TINY_CFG = RendererConfig(width=128, height=64, segment_headroom=512)


@pytest.fixture(scope="module")
def scene():
    return build_orbit_scene(seed=0, **SMALL)


@pytest.fixture(scope="module")
def tiny_scene():
    return build_orbit_scene(seed=1, **TINY)


@pytest.fixture(scope="module")
def cam():
    return orbit_track(8)[3]


@pytest.fixture(scope="module")
def port(scene):
    return Renderer(scene, CFG, device="cpu")


@pytest.fixture(scope="module")
def stage_outputs(port, cam):
    """The port's own stage outputs for the frame, stage by stage."""
    kw, sc = port._frame_kwargs, port.scene
    vp, cp = port.frame_uniforms(cam)
    tiles = dict(tiles_x=port.tiles_x, tiles_y=port.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"])
    so = geometry.triangle_setup(geometry.transform_corners(sc["corner_world"], vp), None, sc["n_faces"],
                                 kw["width"], kw["height"])
    bins = geometry.bin_pairs(so["aabb"], so["valid"], port.tiles_x, port.tiles_y, kw["tile_w"], kw["tile_h"])
    vis = raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"],
                                 clear_depth=kw["clear_depth"], **tiles)
    attrs = resolve.pack_resolve_attrs(so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"],
                                       sc["face_tex"], sc["atlas"])
    g = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=kw["max_anisotropy"])
    plan = sampler.plan_tiles(g, max_anisotropy=kw["max_anisotropy"], **tiles)
    fb = sampler.sample_tiles(
        g, sc["atlas"]["page"], plan, cp, max_anisotropy=kw["max_anisotropy"],
        light_direction=kw["light_direction"], light_color=kw["light_color"], ambient_amount=kw["ambient_amount"],
        specular_power=kw["specular_power"], clear_color=kw["clear_color"], blend=kw["blend"], **tiles,
    )
    return {
        "geometry": (so["setup"], so["valid"], so["aabb"]),
        "binning": (bins["counts"], bins["offsets"], bins["pair_faces"]),
        "raster": (vis,),
        "resolve": (g,),
        "plan": (plan["table"], plan["assign"]),
        "sample": (fb,),
    }


def _probe(renderer, cam, stage, **change):
    out = render_frame(renderer.scene, *renderer.frame_uniforms(cam), **dict(renderer._frame_kwargs, **change),
                       stage=stage)
    assert set(out) == {"stage_probe"}
    probe = out["stage_probe"]
    assert probe.dtype == torch.float32 and probe.shape == ()
    return probe


@pytest.mark.parametrize("stage", ["geometry", "binning", "raster", "resolve", "plan", "sample"])
def test_stage_probe_is_the_sum_of_the_stage_outputs(port, cam, stage_outputs, stage):
    want = torch.zeros((), dtype=torch.float32)
    for t in stage_outputs[stage]:
        want = want + t.to(torch.float32).sum()
    assert torch.isfinite(want) and float(want) != 0.0
    assert torch.equal(_probe(port, cam, stage), want)


@pytest.fixture(scope="module")
def reference_probes(scene, cam):
    """The reference's stage probes, computed once (interpret mode is slow)."""
    ref = RefRenderer(reference_scene(scene), CFG)
    uniforms = ref.frame_uniforms(cam)
    return {s: float(ref_render_frame(ref.scene, *uniforms, **ref._frame_kwargs, stage=s)["stage_probe"])
            for s in ("geometry", "raster")}


@pytest.mark.parametrize("stage", ["geometry", "raster"])
def test_stage_probe_matches_reference(port, cam, reference_probes, stage):
    np.testing.assert_allclose(float(_probe(port, cam, stage)), reference_probes[stage], rtol=2e-6, atol=0)


def test_segments_prefix_is_the_binning_prefix(port, cam):
    assert STAGE_PREFIXES == tuple(s for s in REF_STAGES if s is not None)
    assert torch.equal(_probe(port, cam, "segments"), _probe(port, cam, "binning"))


@pytest.mark.parametrize(
    "stage,change",
    [
        ("shade", {}),
        ("", {}),
        ("plan", dict(sampler="gather")),
        ("sample", dict(sampler="gather")),
        ("sample", dict(shading="deferred", sampler="gather")),
        ("resolve", dict(shading="deferred", sampler="gather")),
    ],
    ids=["unknown", "empty", "plan_gather", "sample_gather", "sample_deferred", "resolve_deferred"],
)
def test_stage_the_path_does_not_have_raises(port, cam, stage, change):
    with pytest.raises(ValueError, match="stage"):
        _probe(port, cam, stage, **change)


# ---------------------------------------------------------------------------
# Presenter.


@pytest.mark.parametrize("as_numpy", [False, True], ids=["tensor", "numpy"])
def test_presenter_hands_out_the_previous_frame(as_numpy):
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (4, 6, 10), dtype=np.uint8) for _ in range(3)]
    p = Presenter()
    assert p.flush() is None
    outs = [p.present(f if as_numpy else torch.from_numpy(f)) for f in frames]
    assert outs[0] is None
    for got, want in zip(outs[1:], frames[:-1]):
        assert got.shape == (6, 10, 4) and got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, np.moveaxis(want, 0, -1))
    np.testing.assert_array_equal(p.flush(), np.moveaxis(frames[-1], 0, -1))
    assert p.flush() is None and p.present(torch.from_numpy(frames[0])) is None


def test_presenter_takes_a_shape_change_between_frames():
    p = Presenter()
    a = torch.arange(4 * 6 * 10, dtype=torch.uint8).reshape(4, 6, 10)
    b = torch.arange(4 * 3 * 5, dtype=torch.uint8).reshape(4, 3, 5)
    assert p.present(a) is None
    assert p.present(b).shape == (6, 10, 4)
    np.testing.assert_array_equal(p.present(a), b.permute(1, 2, 0).numpy())
    assert p.flush().shape == (6, 10, 4)


# ---------------------------------------------------------------------------
# Engine.


def test_engine_loop_double_buffered(tiny_scene):
    """tests/test_pipeline.py::test_engine_loop_double_buffered on the port."""
    eng = Engine(scene=tiny_scene, config=RendererConfig(width=96, height=64), overlay=False, device="cpu")
    first = eng.tick()
    assert first is None  # frame 0 still in flight
    second = eng.tick(move=MoveDirection(forward=True))
    assert second is not None and second.shape == (64, 96, 4) and second.dtype == np.uint8
    final = eng.run(3)
    assert final.shape == (64, 96, 4)
    assert eng.stats.p50_ms > 0 and eng.frame_index == 5
    # Moving forward must change the camera position.
    assert eng.camera.position[2] > -2.5


def test_engine_final_frame_matches_reference(scene):
    """Mouse deltas only: the two engines' cameras stay equal whatever the
    wall clock does, so the final frames are comparable."""
    cfg = dataclasses.replace(CFG, width=128, height=64)
    turns = [(40.0, -10.0), (-25.0, 5.0), (0.0, 0.0)]
    ref = RefEngine(scene=reference_scene(scene), config=cfg, overlay=False)
    want = ref.run(3, controller=lambda i, e: (RefMoveDirection(), turns[i]))
    eng = Engine(scene=scene, config=cfg, overlay=False, device="cpu")
    got = eng.run(3, controller=lambda i, e: (MoveDirection(), turns[i]))
    np.testing.assert_array_equal(eng.camera.view_matrix(), ref.camera.view_matrix())
    assert got.shape == want.shape == (64, 128, 4) and got.dtype == want.dtype
    assert np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32)).max() <= 1
    # The last presented frame is the frame of the last camera.
    np.testing.assert_array_equal(got, eng.renderer.render_to_host(eng.camera))
    assert (got[..., :3] != got[0, 0, :3]).any()  # not a blank frame


def test_engine_reads_counters_one_frame_late_and_resizes(tiny_scene):
    # Untraced, the Engine reads the counters one tick late with .item()
    # (traced, from the counter ring: tests/test_torch_tracing.py).
    eng = Engine(scene=tiny_scene, config=TINY_CFG, overlay=False, device="cpu", trace=False)
    assert eng._pending_overflow is None
    eng.tick()
    assert eng._pending_overflow is not None and eng.dropped_total == 0
    # A counter that says 7 is accounted by the NEXT tick, to the frame before it.
    eng._pending_overflow = torch.tensor(7, dtype=torch.int32)
    eng._pending_window_miss = torch.tensor(3, dtype=torch.int32)
    eng.tick()
    assert (eng.dropped_total, eng.overflow_frames, eng.window_miss_total) == (7, 1, 3)
    eng.resize(64, 32)
    assert eng.tick().shape == (64, 128, 4)  # the frame rendered before the resize
    assert eng.tick().shape == (32, 64, 4)
    eng.resize(0, 0)  # a minimized window keeps the target
    assert eng.run(1).shape == (32, 64, 4)


def test_engine_needs_a_scene_or_a_data_dir_and_defaults_to_the_card():
    import inspect

    with pytest.raises(ValueError, match="data_dir"):
        Engine(device="cpu")
    assert inspect.signature(Engine).parameters["device"].default == "cuda"
    assert Engine.MAX_TIMESTEP == RefEngine.MAX_TIMESTEP


def test_engine_vsync_caps_the_loop(tiny_scene):
    eng = Engine(scene=tiny_scene, config=RendererConfig(width=32, height=32), overlay=False, device="cpu")
    eng.vsync = True
    eng.renderer.render = lambda camera: {  # a frame that costs nothing
        "color": torch.zeros((4, 32, 32), dtype=torch.uint8),
        "bin_overflow": torch.zeros((), dtype=torch.int32),
        "window_miss_px": torch.zeros((), dtype=torch.int32),
    }
    eng.run(3)
    assert min(eng.stats.samples_ms) >= 1000.0 / 60.0 - 0.5


def test_frame_stats_match_reference():
    rng = np.random.default_rng(3)
    got, want = FrameStats(window=16), RefFrameStats(window=16)
    assert (got.last_ms, got.p50_ms, got.fps) == (want.last_ms, want.p50_ms, want.fps) == (0.0, 0.0, 0.0)
    for s in rng.uniform(1e-3, 3e-2, 40):
        got.record(s)
        want.record(s)
    assert got.samples_ms == want.samples_ms and len(got.samples_ms) == 16
    assert (got.last_ms, got.p50_ms, got.fps, got.percentile(95)) == (
        want.last_ms, want.p50_ms, want.fps, want.percentile(95))


# ---------------------------------------------------------------------------
# stage_sweep.


@pytest.mark.parametrize("change", [{}, dict(sampler="gather"), dict(shading="deferred")],
                         ids=["window", "gather", "deferred"])
def test_stage_sweep_keys_and_deltas(tiny_scene, change):
    r = Renderer(tiny_scene, dataclasses.replace(TINY_CFG, **change), device="cpu")
    uniforms = [r.frame_uniforms(c) for c in orbit_track(8)[:3]]
    cum, delta = profiling.stage_sweep(r, uniforms, frames=2, group=1, warmup=1)
    want = [s or "frame" for s in REF_STAGES]
    if change:
        want = [s for s in want if s not in ("plan", "sample")]
    if change.get("shading") == "deferred":
        want.remove("resolve")
    assert list(cum) == list(delta) == want
    assert all(v > 0 for v in cum.values())
    assert sum(delta.values()) == pytest.approx(cum["frame"], abs=0.001 * len(delta))
    assert profiling.STAGES == REF_STAGES


def test_time_groups_times_every_group_and_reports_its_last_result():
    scene = {"corner_world": torch.zeros(1)}
    seen = []
    times = profiling.time_groups(lambda sc, a: a * 2, scene, [(k,) for k in range(5)], group=2,
                                  after_group=seen.append)
    assert len(times) == 3 and all(t >= 0 for t in times) and seen == [2, 6, 8]


# ---------------------------------------------------------------------------
# The bench entry point.

BENCH_FIELDS = {
    "metric", "value", "unit", "p50_frame_ms", "mean_frame_ms", "mtris_per_sec", "triangles", "frames", "wall_s",
    "dropped_pairs", "window_miss_px", "parity_max_lsb", "stage_ms", "present_ms_per_frame", "present_fps",
    "backend", "device", "power_limit_w", "binning", "capture_ms", "graph_pool_bytes",
}


@pytest.fixture
def tiny_orbit(monkeypatch, tmp_path):
    """--scene orbit builds the procedural scene cut small, cached under a
    temporary directory."""
    monkeypatch.setattr(scene_mod, "build_orbit_scene", functools.partial(build_orbit_scene, **TINY))
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE_DIR", str(tmp_path))


def test_cli_prints_one_json_line_on_the_cpu(tiny_orbit, capsys):
    rc = cli.main(["--device", "cpu", "--scene", "orbit", "--width", "128", "--height", "64", "--frames", "4",
                   "--warmup", "1", "--seed", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == BENCH_FIELDS
    assert res["metric"] == "fps_128x64_orbit_scene" and res["unit"] == "frames/sec"
    assert res["parity_max_lsb"] == 0 and res["dropped_pairs"] == 0 and res["window_miss_px"] == 0
    assert res["backend"] == "cpu" and res["device"] == "cpu" and res["power_limit_w"] is None
    assert res["capture_ms"] is None and res["graph_pool_bytes"] is None  # no graph on the CPU
    assert res["frames"] == 4 and res["stage_ms"] is None and res["binning"] == "pairs"
    assert res["triangles"] == build_orbit_scene(seed=1, **TINY).n_faces
    assert res["p50_frame_ms"] > 0 and res["present_ms_per_frame"] > 0
    # value is fps rounded to 2 decimals, p50_frame_ms to 4.
    assert res["value"] == pytest.approx(1000.0 / res["p50_frame_ms"], abs=0.0051, rel=1e-4)


def test_cli_runs_scan_binning(tiny_orbit, capsys):
    rc = cli.main(["--device", "cpu", "--scene", "orbit", "--width", "128", "--height", "64", "--frames", "2",
                   "--warmup", "1", "--seed", "1", "--binning", "scan"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["binning"] == "scan" and res["parity_max_lsb"] == 0 and res["dropped_pairs"] == 0


def test_cli_stages_adds_the_sweep(tiny_orbit, capsys, monkeypatch):
    # stage_ms comes from the timed frames' own stage marks, keyed by the
    # marks' stage names (no prefix graphs): tpurast_torch/tracing.py.
    rc = cli.main(["--device", "cpu", "--scene", "orbit", "--width", "128", "--height", "64", "--frames", "1",
                   "--warmup", "0", "--skip-parity-gate", "--stages", "--seed", "1"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["parity_max_lsb"] is None
    assert list(res["stage_ms"]) == ["geometry", "binning", "raster", "pack", "shading", "encode"]


def test_cli_without_a_card_fails_loudly(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--scene", "orbit", "--frames", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err


def test_cli_names_a_missing_data_directory(tmp_path, capsys):
    missing = str(tmp_path / "no_such_data")
    assert cli.main(["--device", "cpu", "--scene", "hdr", "--data-dir", missing]) != 0
    out = capsys.readouterr()
    assert out.out == "" and missing in out.err
    assert cli.main(["--device", "cpu", "--scene", "demo"]) != 0  # no --data-dir at all
    assert capsys.readouterr().out == ""


def test_cli_refuses_to_print_a_time_when_the_gate_fails(tiny_orbit, capsys, monkeypatch):
    """A kernel that disagrees with its plain version: here the 'plain'
    side is made to clear to another color."""
    import contextlib

    @contextlib.contextmanager
    def broken():
        saved = Renderer.render_to_host
        Renderer.render_to_host = lambda self, cam: 255 - saved(self, cam)
        try:
            yield
        finally:
            Renderer.render_to_host = saved

    monkeypatch.setattr(kernels, "plain_kernels", broken)
    rc = cli.main(["--device", "cpu", "--scene", "orbit", "--width", "128", "--height", "64", "--frames", "1",
                   "--seed", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == "parity_gate_failed" and res["value"] > 1 and "p50_frame_ms" not in res


def test_cli_all_drops_the_options_it_sets_itself():
    argv = ["--all", "--scene", "hdr", "--frames", "8", "--width=640", "--height", "480", "--stages"]
    assert cli._without_scene_and_size(argv) == ["--frames", "8", "--stages"]
    assert [label for _, label in cli.ALL_CONFIGS][0] == "orbit_1080p"
    for extra, _ in cli.ALL_CONFIGS:
        args = cli._build_parser().parse_args(extra)
        assert args.scene in scene_cache.SCENES


def test_plain_kernels_context_nests_and_unwinds():
    t = torch.zeros(1)
    assert kernels._plain_depth == 0 and kernels.use_kernel(t) is False
    with pytest.raises(RuntimeError):
        with kernels.plain_kernels():
            with kernels.plain_kernels():
                assert kernels._plain_depth == 2
            assert kernels._plain_depth == 1
            raise RuntimeError("unwind")
    assert kernels._plain_depth == 0


# ---------------------------------------------------------------------------
# Named scenes and their cache.


def _assert_scenes_equal(a, b):
    assert type(a) is type(b) is scene_mod.DeviceScene
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif dataclasses.is_dataclass(x):
            for g in dataclasses.fields(x):
                np.testing.assert_array_equal(getattr(x, g.name), getattr(y, g.name), err_msg=f"{f.name}.{g.name}")
        else:
            assert x == y, f.name


def test_named_orbit_scene_cached_and_uncached_agree(monkeypatch, tmp_path):
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE_DIR", str(tmp_path))
    built = scene_cache.load_named_scene("orbit", seed=5, **TINY)  # builds and writes the pickle
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("orbit.") and files[0].endswith(f".v{scene_cache.CACHE_VERSION}.pkl")
    monkeypatch.setattr(scene_mod, "build_orbit_scene", None)  # a hit must not build
    cached = scene_cache.load_named_scene("orbit", seed=5, **TINY)
    monkeypatch.undo()
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE", "0")
    uncached = scene_cache.load_named_scene("orbit", seed=5, **TINY)
    _assert_scenes_equal(cached, built)
    _assert_scenes_equal(cached, uncached)
    # Other keyword arguments are another key.
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE", "1")
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE_DIR", str(tmp_path))
    other = scene_cache.load_named_scene("orbit", seed=6, **TINY)
    assert len(list(tmp_path.iterdir())) == 2
    assert not np.array_equal(other.pages.planes, cached.pages.planes)


def test_named_scene_errors(tmp_path):
    with pytest.raises(ValueError, match="unknown scene"):
        scene_cache.load_named_scene("teapot", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no_such_data"):
        scene_cache.load_named_scene("dragons64", str(tmp_path / "no_such_data"))
    with pytest.raises(FileNotFoundError):
        scene_cache.load_named_scene("demo", None)
    assert str(scene_cache.cache_dir()).endswith(".scene_cache/tpurast_torch")


def assert_named_scene_matches_reference(name: str, data_dir) -> object:
    """The port's load_named_scene(name, data_dir) against the reference's
    loader on the same directory: faces, the per-draw arrays, prim_tex,
    the atlas (offsets, sizes, mip counts and the quad rows) and the page
    planes, exactly. Returns the port's scene. The caller turns the scene
    cache off."""
    from tpurast.device import scene as ref_scene_mod

    got = scene_cache.load_named_scene(name, str(data_dir))
    want = {
        "demo": ref_scene_mod.load_demo_scene,
        "hdr": ref_scene_mod.load_hdr_scene,
        "porsche_class": ref_scene_mod.load_porsche_class_scene,
        "dragons64": lambda d: ref_scene_mod.load_instanced_dragons(d, 64),
    }[name](str(data_dir))
    assert got.n_faces == want.n_faces and got.texture_uris == want.texture_uris
    for f in ("positions", "normals", "uvs", "faces", "face_prim", "models", "normal_mats", "prim_tex"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(got.pages.planes, want.pages.planes)
    for f in ("offsets", "sizes", "n_mips", "texels"):
        np.testing.assert_array_equal(getattr(got.atlas, f), getattr(want.atlas, f), err_msg=f"atlas.{f}")
    return got


@pytest.mark.parametrize("name", ["demo", "hdr", "porsche_class", "dragons64"])
def test_named_scenes_from_the_data_directory(data_dir, name, monkeypatch):
    """The loaders that read the reference's data against the reference's."""
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE", "0")
    assert_named_scene_matches_reference(name, data_dir)
