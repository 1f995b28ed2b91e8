"""The instanced dragons at 4K on the bench's flythrough: its configuration
and traffic files, the two readers of the binner's face counts
(metrics/cut_faces.py, huge_faces_max.py) on planted records, None where
there is nothing to read, a tiny run of the flythrough on the CPU, and the
control that lowers the geometry (control_vertices.py)."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import loops, program_trace, run, trace
from portbench.run import Run
from portbench.scenes import tracks
from portbench.tests.conftest import TINY_FRAMES

NEW_CELLS = ["dragons64_4k.flythrough", "porsche_class_1080p.flythrough"]
READERS = ("cut_faces", "huge_faces_max")


class Snap:
    def __init__(self, frames):
        self.spans, self.frames, self.calibrations = {}, {"cuda:0": frames}, {}


def _run(monkeypatch, frames, with_counts=True, reading=True):
    """Frames 1..8: 2..5 the untraced window, 6..8 the traced slice; cut
    faces 10 q and huge faces q % 3 + 60 in frame q."""
    seq = np.arange(1, 9)
    recs = {"seq": seq, "t_ns": seq[:, None] * 1_000_000 + np.arange(7)[None, :], "overflow": np.zeros(8, np.int64),
            "miss": np.zeros(8, np.int64)}
    if with_counts:
        recs.update(cut=10 * seq, huge=seq % 3 + 60)
    window = loops.Window(frames=4, seconds=1.0, intervals_ms=np.ones(4), render_host_ms=0.1, present_host_ms=None,
                          overflow=[], sample=[])
    got = trace.Reading(loop="render", frames=frames, busy_s=1.0, window_s=1.0, layer_ms={}, other_ms=0.0,
                        bounds={}, device_ops=[], idle_gaps=[]) if reading else None
    r = Run(setup_s=1.0, window=window, reading=got)
    monkeypatch.setattr(program_trace, "_last", [r, Snap(recs)])
    return r


def test_readers_on_planted_records(monkeypatch):
    r = _run(monkeypatch, 3)
    assert run.reader("cut_faces").read(r) == pytest.approx(np.mean([20, 30, 40, 50]))
    assert run.reader("huge_faces_max").read(r) == 62.0  # frames 2..5: 62, 60, 61, 62; the slice's not read


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_not_zero(monkeypatch, name):
    reader = run.reader(name)
    assert reader.read(_run(monkeypatch, 3, reading=False)) is None  # a run without a trace
    assert reader.read(_run(monkeypatch, 3, with_counts=False)) is None  # a program without the counts
    assert reader.read(_run(monkeypatch, 9)) is None  # fewer records than the slice's frames
    monkeypatch.setattr(program_trace, "_last", [None, None])
    r = Run(setup_s=1.0, window=None, reading=None)
    assert reader.read(r) is None


def test_manifest_lists_the_new_cells(manifest):
    cells = {w["name"]: w for w in manifest["workloads"]}
    assert cells["dragons64_4k.flythrough"]["config"] == "dragons64_4k"
    assert all(cells[c]["traffic"] == "flythrough" and cells[c]["chips"] == 1 for c in NEW_CELLS)
    per_layer = {m["name"]: m for m in manifest["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert (m["unit"], m["better"], m["moves"], m["workloads"]) == ("faces", "lower", "frame_ms", NEW_CELLS)
        assert run.reader(name).UNIT == "faces"
    assert "porsche_class_1080p.flythrough" in per_layer["sample_roofline_pct"]["workloads"]
    assert not set(NEW_CELLS) & set(per_layer["raster_roofline_pct"]["workloads"])
    for cell in NEW_CELLS:
        assert {m["name"] for m in run.cell_metrics(manifest, cell, False)} == {"frame_ms", "frame_p95_ms", "setup_s"}


def test_dragons_config_and_flythrough_track(manifest):
    entry = next(c for c in manifest["configs"] if c["name"] == "dragons64_4k")
    config = run.load_json(run.ROOT / entry["file"])
    assert config["scene"] == {"kind": "standin_dragons64", "scale": "full", "count": 64, "spacing": 0.35}
    assert (config["width"], config["height"], config["renderer"], config["reduced"]) == (3840, 2160, {}, [])
    assert entry["reduced"] == [] and len(config["assumed"]) == 4
    traffic = run.load_json(run.BENCH / "traffic" / "flythrough.json")
    assert (traffic["loop"], traffic["poses"], traffic["renderer"], traffic["limits"]) == ("render", 628, {},
                                                                                           {"max_lsb": 1})
    # The poses are the repository bench's flythrough cameras.
    from tpurast_torch import cli

    poses = tracks.circle_track(traffic["track"], traffic["poses"])
    cams = cli.flythrough("demo", traffic["poses"])
    for (pos, target), cam in zip(poses, cams):
        np.testing.assert_allclose(pos, cam.position, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(target, np.array([0.0, 0.95, 0.0], np.float32))


def test_porsche_flythrough_drops_nothing(tiny, manifest):
    """The porsche-class scene on the flythrough at the tests' size, on the
    CPU: correct, no pair dropped."""
    config, traffic = tiny("porsche_class_1080p.flythrough")
    res = run.run_cell(config, traffic, run.cell_metrics(manifest, "porsche_class_1080p.flythrough", False),
                       2400200001, 1.0, False, device="cpu", **TINY_FRAMES)
    assert res["correct"] and res["failed"] == 0, res["compared"]
    assert res["compared"]["dropped_pair_frames"] == {"value": 0.0, "limit": 0}


def test_control_vertices_lowers_the_geometry(tiny, tmp_path):
    """control_vertices.py renders the reference from corner tables rounded
    to float16: the tables change, within float16's rounding, and the frames
    keep the reference's shape and type."""
    from portbench import check, control_vertices, scenes
    from portbench.reference import render as rrender
    from portbench.reference import scene as rscene

    config, traffic = tiny("dragons64_4k.flythrough")
    inputs = scenes.scene_inputs(dict(config["scene"], count=4), 7, tmp_path)
    scene = rscene.from_inputs(inputs)
    world = scene.corner_world.copy()
    low = control_vertices.lowered(scene).corner_world
    assert not np.array_equal(low, world)
    np.testing.assert_allclose(low, world, rtol=2.0**-11, atol=2.0**-24)
    target = rrender.target_of(config, {})
    poses = tracks.circle_track(dict(traffic["track"], radius=2.5), 1)
    got = control_vertices.frames(inputs, {}, target, poses, "cpu")
    want, _ = check.reference_frames(inputs, {}, target, poses, "cpu")
    assert got[0].shape == want[0].shape and got[0].dtype == want[0].dtype
