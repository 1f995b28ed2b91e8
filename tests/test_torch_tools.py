"""The port's analysis tools (tpurast_torch/tools, counterparts of the
reference's tools/ scripts) on the CPU, at tests/test_torch_runtime.py's
TINY orbit scene, 128x64.

Each tool's main([..., "--device", "cpu"]) returns 0 and prints the lines
its reference prints: the same JSON keys in the same order, the same
line formats (the reference's tools read the data directory, which is not
here, so their format strings are the yardstick). sampler_sim reads the
G-buffer that residual_analysis keeps, under the directory the caller
names. Without a card and without --device cpu a tool exits 2 and prints
nothing. device/charts.py::face_charts, a copy, equals the reference's on
a small mesh.
"""

import ast
import functools
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from tpurast.device.charts import face_charts as ref_face_charts
from tpurast.profiling import STAGES as REF_STAGES
from tpurast_torch.device import scene as scene_mod
from tpurast_torch.device.charts import face_charts
from tpurast_torch.device.scene import build_orbit_scene
from tpurast_torch.tools import (aniso_mode_stats, check_sampler, profile_sampler, profile_stages, residual_analysis,
                                 sample_stage_probe, sampler_plan_stats, sampler_sim)
from test_torch_runtime import TINY
from test_torch_scene import numpy_bc_decoders  # noqa: F401  (module-wide autouse)

SMALL = ["--width", "128", "--height", "64", "--device", "cpu", "--seed", "1"]


@pytest.fixture(autouse=True)
def tiny_orbit(monkeypatch):
    """--scene orbit builds the procedural scene cut small, uncached."""
    monkeypatch.setattr(scene_mod, "build_orbit_scene", functools.partial(build_orbit_scene, **TINY))
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE", "0")


def _run(capsys, mod, argv):
    rc = mod.main(argv)
    out = capsys.readouterr()
    assert rc == 0, out.err
    return out.out.strip().splitlines()


def test_profile_stages(capsys):
    (line,) = _run(capsys, profile_stages, SMALL + ["--frames", "1"])
    res = json.loads(line)
    assert list(res) == ["cum_ms", "stage_ms"]
    assert list(res["cum_ms"]) == list(res["stage_ms"]) == [s or "frame" for s in REF_STAGES]
    assert all(v > 0 for v in res["cum_ms"].values())


def test_sample_stage_probe(capsys):
    lines = _run(capsys, sample_stage_probe, SMALL + ["--frames", "1", "--stages", "plan,sample,frame"])
    res = [json.loads(x) for x in lines]
    assert [list(r) for r in res] == [["plan"], ["sample"], ["frame"], ["cum_ms"]]
    assert res[-1]["cum_ms"] == {k: v for r in res[:-1] for k, v in r.items()}


def test_profile_sampler(capsys):
    res = [json.loads(x) for x in _run(capsys, profile_sampler, SMALL + ["--frames", "2"])]
    assert res[0] == {"sampler_resolved": "window", "max_anisotropy": 16}
    assert [list(r) for r in res[1:4]] == [["prefix(geom..resolve)"], ["plan"], ["sample"]]
    assert list(res[4]) == ["prefix(geom..resolve)", "plan", "sample", "tiles", "full"]
    tiles = res[4]["tiles"]
    assert list(tiles) == ["windowed", "residual", "empty", "n_used_mean", "n_used_p95", "nprobe_mean", "nprobe_p95",
                           "second_wave_tiles"]
    assert tiles["windowed"] + tiles["residual"] + tiles["empty"] == 2 and tiles["windowed"] > 0
    assert 1 <= tiles["nprobe_mean"] <= 16


def test_sampler_plan_stats(capsys):
    lines = _run(capsys, sampler_plan_stats, SMALL)
    assert re.fullmatch(r"window: \d+\.\d\d ms/frame  miss_px=0", lines[0])
    assert re.fullmatch(r"gather: \d+\.\d\d ms/frame  miss_px=0", lines[1])
    assert [x.split(":")[0] for x in lines[2:6]] == ["class A(wide)", "class B(tall)", "class empty",
                                                    "class RESIDUAL"]
    assert sum(int(x.split(": ")[1].split(" / ")[0]) for x in lines[2:6]) == 2
    assert lines[6] == "residual_px: 0" and lines[7].startswith("nprobe histogram: {")


def test_check_sampler(capsys):
    lines = _run(capsys, check_sampler, ["--device", "cpu", "--seed", "1", "--frames", "2"])
    assert len(lines) == 3
    for k, line in enumerate(lines[:2]):
        assert re.fullmatch(rf"frame {k}: max_lsb=[01] window_miss_px=0 \(window \d+ ms, gather \d+ ms\)", line)
    assert re.fullmatch(r"WORST max_lsb=[01] budget=1 -> OK", lines[2])


def test_aniso_mode_stats(capsys):
    res = json.loads("\n".join(_run(capsys, aniso_mode_stats, SMALL)))
    assert list(res) == ["matched", "own", "parent"] and res["matched"] > 500
    for lvl in ("own", "parent"):
        s = res[lvl]
        assert list(s) == ["iso", "xsep", "ysep", "diag", "diag_np_hist", "xsep_n_hist"]
        assert s["iso"] + s["xsep"] + s["ysep"] + s["diag"] == res["matched"]
        assert len(s["diag_np_hist"]) == len(s["xsep_n_hist"]) == 16 and sum(s["diag_np_hist"]) == s["diag"]


def test_residual_analysis_then_sampler_sim(capsys, tmp_path):
    argv = SMALL + ["--gbuf-dir", str(tmp_path)]
    first = _run(capsys, residual_analysis, argv)
    assert [p.name for p in tmp_path.iterdir()] == ["gbuf_orbit_1_128x64_0.4.npz"]
    again = _run(capsys, residual_analysis, argv)
    assert again[0] == f"loaded cached gbuf {tmp_path / 'gbuf_orbit_1_128x64_0.4.npz'}" and again[1:] == first
    assert re.fullmatch(r"orbit: \d+ faces, \d+ charts", first[0])
    assert re.fullmatch(r"chart sizes: p50=\d+ p90=\d+ max=\d+", first[1])
    assert first[2].startswith("per-tile distinct (tex,mip) jobs: {")
    assert first[3].startswith("per-tile distinct (chart,mip) jobs: {")
    for line, name in zip(first[4:7], ("(tex,mip) bbox", "(chart,mip) bbox", "chart min(bbox,rect)")):
        assert re.fullmatch(rf"{re.escape(name)} need: x p50=\d+ p90=\d+ p99=\d+ max=\d+ \| "
                            r"y p50=\d+ p90=\d+ p99=\d+ max=\d+", line)
    for line, (n, wy, wx) in zip(first[7:], residual_analysis.CANDIDATES, strict=True):
        assert re.fullmatch(rf"slots={n} window=\({wy},{wx}\): \d+/2 covered tiles fit", line)

    sim = _run(capsys, sampler_sim, ["--width", "128", "--height", "64", "--seed", "1", "--gbuf-dir", str(tmp_path)])
    assert len(sim) == 2 * len(sampler_sim.CANDIDATES)
    for k, (wh, ww, kk) in enumerate(sampler_sim.CANDIDATES):
        assert re.fullmatch(rf"WH={wh} WW={ww} K={kk}: fit \d+/2 tiles, residual \d+ tiles / \d+px \(\d+\.\d\d%\), "
                            r"slots p50=\d+ p90=\d+ max=\d+, mean=\d+\.\d\d", sim[2 * k])
        assert sim[2 * k + 1].startswith("  slots hist: {")
    assert sampler_sim.main(["--gbuf-dir", str(tmp_path / "none")]) == 2
    assert capsys.readouterr().out == ""


TOOLS = [profile_stages, sample_stage_probe, profile_sampler, sampler_plan_stats, check_sampler, aniso_mode_stats,
         residual_analysis]


@pytest.mark.parametrize("mod", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_without_a_card_exits_2(monkeypatch, capsys, mod):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["--frames", "1"] if mod in (profile_stages, sample_stage_probe, profile_sampler) else []) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err


def test_face_charts_match_reference():
    """Two strips of quads sharing vertices (one chart each), a lone
    triangle, an unused vertex, padding rows."""
    rng = np.random.default_rng(4)
    strip = np.array([[i, i + 1, i + 2] for i in range(10)])
    faces = np.concatenate([strip, strip + 20, [[40, 41, 42]], rng.integers(0, 43, (5, 3))]).astype(np.int32)
    for n in (0, 10, 21, 26):
        got, want = face_charts(faces, n, 44), ref_face_charts(faces, n, 44)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert face_charts(faces, 21, 44)[:21].max() == 2


def test_profiler_graph_crash_without_a_card_exits_2(monkeypatch, capsys):
    """The crash reproducer needs a card; without one it says so and exits
    2. It imports torch alone (no module of the port), so that it shows the
    crash outside the port."""
    from tpurast_torch.tools import profiler_graph_crash

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler_graph_crash.main(["--kernel", "torch"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    tree = ast.parse(pathlib.Path(profiler_graph_crash.__file__).read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not any(m.startswith("tpurast") for m in imported)
