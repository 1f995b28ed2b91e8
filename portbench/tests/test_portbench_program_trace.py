"""The readers of the program's own trace (portbench/program_trace.py and
the eleven metrics that read it) on a planted snapshot, and None where the
program has no trace or the run no traced slice."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import loops, program_trace, run, trace
from portbench.run import Run

NEW = ("geometry_ms", "binning_ms", "pack_ms", "encode_ms", "between_frames_ms", "present_wait_ms",
       "present_copy_ms", "host_bound_ms", "setup_scene_s", "setup_upload_s", "setup_capture_s")


class Snap:
    def __init__(self, spans, frames):
        self.spans, self.frames, self.calibrations = spans, frames, {}


def _window(frames=4):
    return loops.Window(frames=frames, seconds=1.0, intervals_ms=np.ones(frames), render_host_ms=0.1,
                        present_host_ms=None, overflow=[], sample=[])


def _reading(frames):
    return trace.Reading(loop="render", frames=frames, busy_s=1.0, window_s=1.0, layer_ms={}, other_ms=0.0,
                         bounds={}, device_ops=[], idle_gaps=[])


def _planted():
    """Frames 1..8, 1 ms apart, marks 0, 0.1, 0.3, 0.6, 0.7, 0.85 and 0.9 ms
    after each frame's start: frame 1 a warm-up, 2..5 the untraced window,
    6..8 the traced slice, whose marks after the first come 50 us later
    (the profiler's cost, which the window's readings leave out). Frame q is enqueued 50 us before frame q-1's last
    mark (q odd) or 200 us after it (q even); its present.wait lasts
    0.4 ms + q us, its present.copy 0.6 ms. Set-up spans of 2, 3 and 4 s."""
    seq = np.arange(1, 9)
    t = seq[:, None] * 1_000_000 + np.array([0, 100_000, 300_000, 600_000, 700_000, 850_000, 900_000])[None, :]
    t[5:, 1:] += 50_000
    frames = {"seq": seq, "t_ns": t, "overflow": np.zeros(8, np.int64), "miss": np.zeros(8, np.int64)}
    rows = [  # id, name, parent, frame, start, end
        (1, "setup.scene", -1, 0, 0, 2_000_000_000),
        (2, "setup.upload", -1, 0, 0, 3_000_000_000),
        (3, "frame", -1, 1, 0, 10),
        (4, "setup.capture", 3, 1, 0, 4_000_000_000),
        (5, "setup.capture", -1, 1, 0, 9),  # another graph's: not the frame graph's
    ]
    for q in seq[1:]:
        end = int(t[q - 2, -1] + (-50_000 if q % 2 else 200_000))
        rows += [(10 * q, "frame", -1, q, end - 20_000, end),
                 (10 * q + 1, "present.wait", -1, q, end, end + 400_000 + 1000 * q),
                 (10 * q + 2, "present.copy", -1, q, end, end + 600_000)]
    cols = list(zip(*sorted(rows)))
    spans = {k: np.array(cols[i], dtype=np.int64) for i, k in ((0, "id"), (2, "parent"), (3, "frame"),
                                                                 (4, "start_ns"), (5, "end_ns"))}
    spans["name"] = np.array(cols[1], dtype=object)
    return Snap(spans, {"cuda:0": frames}), 3


def _run(monkeypatch, snap, frames):
    r = Run(setup_s=1.0, window=_window(), reading=_reading(frames))
    monkeypatch.setattr(program_trace, "_last", [r, snap])
    return r


def test_readers_on_a_planted_snapshot(monkeypatch):
    snap, n = _planted()
    r = _run(monkeypatch, snap, n)
    got = {name: run.reader(name).read(r) for name in NEW}
    assert program_trace.frames(r)["seq"].tolist() == [6, 7, 8] and program_trace.window(r) == (2, 5)
    assert got["geometry_ms"] == pytest.approx(0.1) and got["binning_ms"] == pytest.approx(0.2)
    assert got["pack_ms"] == pytest.approx(0.1) and got["encode_ms"] == pytest.approx(0.05)
    assert got["between_frames_ms"] == pytest.approx(0.1)  # 1 ms apart, 0.9 ms of marks
    assert program_trace.mark_interval_ms(r, "start", "geometry") == pytest.approx(0.1)  # the window's, not 0.15
    # The window's frames 2..5.
    assert got["present_wait_ms"] == pytest.approx(0.4 + 0.0035)
    assert got["present_copy_ms"] == pytest.approx(0.6)
    # Frames 3, 4, 5 enqueued 50 us before, 200 us after, 50 us before the last mark of the one before.
    assert got["host_bound_ms"] == pytest.approx(0.2 / 3)
    assert (got["setup_scene_s"], got["setup_upload_s"], got["setup_capture_s"]) == (2.0, 3.0, 4.0)


def test_no_reading_without_a_trace(monkeypatch):
    snap, n = _planted()
    untraced = Run(setup_s=1.0, window=_window(), reading=None)
    assert all(run.reader(name).read(untraced) is None for name in NEW)
    r = _run(monkeypatch, None, n)  # a program without tpurast_torch.tracing
    assert all(run.reader(name).read(r) is None for name in NEW)
    r = _run(monkeypatch, snap, 9)  # fewer records than the slice's frames
    assert all(run.reader(name).read(r) is None for name in NEW[:8])
    empty = Snap({k: v[:0] for k, v in snap.spans.items()}, {})
    r = _run(monkeypatch, empty, n)  # a trace that saw nothing
    assert all(run.reader(name).read(r) is None for name in NEW)


def test_a_program_without_a_trace_reads_none(monkeypatch):
    import sys

    import tpurast_torch

    # The import fails, as on a checkout whose program has no trace.
    monkeypatch.setitem(sys.modules, "tpurast_torch.tracing", None)
    monkeypatch.delattr(tpurast_torch, "tracing", raising=False)
    monkeypatch.setattr(program_trace, "_last", [None, None])
    r = Run(setup_s=1.0, window=_window(), reading=_reading(3))
    assert program_trace.snapshot(r) is None
    assert all(run.reader(name).read(r) is None for name in NEW)
