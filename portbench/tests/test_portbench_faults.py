"""Whole runs on the CPU: a sound program comes out correct, and a program
broken underneath the timed path comes out not correct, once for each
fault a render cell can have (a frame that is not the pose's, half of the
frame left out, a frame altered where it is produced, pairs dropped by the
binner in a few frames). The cells have one chip, so there is no exchange
between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests.conftest import TINY_FRAMES
from tpurast_torch.renderer import Renderer

CLEAR = torch.tensor([255, 0, 255, 255], dtype=torch.uint8)[:, None, None]


def _stale(real):
    first = {}

    def fn(self, view_proj, camera_position):
        out = real(self, view_proj, camera_position)
        return first.setdefault("out", out)

    return fn


def _half(real):
    def fn(self, view_proj, camera_position):
        out = dict(real(self, view_proj, camera_position))
        color = out["color"].clone()
        color[:, color.shape[1] // 2 :, :] = CLEAR
        out["color"] = color
        return out

    return fn


def _altered(real):
    def fn(self, view_proj, camera_position):
        out = dict(real(self, view_proj, camera_position))
        color = out["color"].clone()
        color[0, 8:24, 8:40] = color[0, 8:24, 8:40] ^ 0x10
        out["color"] = color
        return out

    return fn


def _dropping(real):
    """Every second frame reports pairs dropped; its colour is untouched."""
    seen = {"n": 0}

    def fn(self, view_proj, camera_position):
        out = dict(real(self, view_proj, camera_position))
        seen["n"] += 1
        if seen["n"] % 2 == 0:
            out["bin_overflow"] = out["bin_overflow"] + 7
        return out

    return fn


FLYTHROUGH, PRESENT = "porsche_class_1080p.viewer_orbit", "porsche_class_1080p.viewer_orbit_present"


def _cell(tiny, manifest, workload, seconds=1.0):
    """A run of the cell at the tests' size on the CPU (a frame takes some
    seconds there: 8 s hold frames of several poses)."""
    config, traffic = tiny(workload)
    return run.run_cell(config, traffic, run.cell_metrics(manifest, workload, False), 20251017, seconds, False,
                        device="cpu", **TINY_FRAMES)


@pytest.mark.parametrize("workload", [FLYTHROUGH, PRESENT])
def test_sound_program_is_correct(tiny, manifest, workload):
    res = _cell(tiny, manifest, workload)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in run.cell_metrics(manifest, workload, False)}
    assert list(res)[-1] == "compared" and len(res["intervals_ms"]) == res["attempted"]
    assert res["compared"]["dropped_pair_frames"] == {"value": 0.0, "limit": 0}


@pytest.mark.parametrize("fault", [_stale, _half, _altered], ids=["stale-frame", "half-frame", "altered-frame"])
@pytest.mark.parametrize("workload", [FLYTHROUGH, PRESENT])
def test_broken_program_is_not_correct(tiny, manifest, monkeypatch, fault, workload):
    monkeypatch.setattr(Renderer, "render_with_uniforms", fault(Renderer.render_with_uniforms))
    res = _cell(tiny, manifest, workload, seconds=8.0)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("workload", [FLYTHROUGH, PRESENT])
def test_dropped_pairs_are_not_correct(tiny, manifest, monkeypatch, workload):
    """Frames that drop pairs fail the run even where every sampled frame
    matches the reference: each frame's counter is read, not a sample."""
    monkeypatch.setattr(Renderer, "render_with_uniforms", _dropping(Renderer.render_with_uniforms))
    res = _cell(tiny, manifest, workload, seconds=8.0)
    assert res["failed"] >= 1 and not res["correct"], res
    assert res["compared"]["dropped_pair_frames"]["value"] == res["failed"]
