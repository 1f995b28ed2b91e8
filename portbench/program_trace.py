"""The program's own trace (tpurast_torch/tracing.py), as the per-layer
metrics read it.

The only module of the benchmark that reads tpurast_torch.tracing.snapshot(),
once a run, after the traced slice: the snapshot calibrates the card's clock
once more and copies the program's rings. A program without a trace (no
tpurast_torch.tracing, or a Renderer built without one) gives None, and so
does every reader of it: no reading is never 0.

  frames(run)  the records of the traced slice: the last run.reading.frames
               whole frame records of the ring, sequence numbers t_ns (n, 7)
               on the host's clock, one column a mark (MARKS)
  window(run)  the sequence numbers of the untraced window's frames, the
               run.window.frames before the slice
  records(run, lo, hi)  the whole records of frames lo..hi the ring holds
  window_records(run)   those of the untraced window's frames: its last
               4,096 less the slice's, as many as the ring holds
  spans(run)   every span, the set-up's and the frames'
  frame_spans(run, name, lo, hi)  the closed spans of that name begun in
               frames lo..hi
  setup_span_s(run, name) the last span of that name, in seconds

Every metric of the frame loop is read over the untraced window, as the
harness's own host clocks are: under the traced slice's profiler the host
slows, and with it the card, which waits for it between frames and pays
CUPTI's cost on each of some 330 small kernels a frame. The stage marks run
on the card's own clock and need no profiler; the slice's records remain
for a check of the marks against the device trace of the same frames.
"""

from __future__ import annotations

import numpy as np

#: tpurast_torch.tracing.MARKS, the columns of frames(run)["t_ns"].
MARKS = ("start", "geometry", "binning", "raster", "pack", "shading", "encode")

_last: list = [None, None]  # [run, snapshot]


def snapshot(run):
    """The program's trace after the traced slice, or None."""
    if run.reading is None:
        return None
    if _last[0] is not run:
        try:
            from tpurast_torch import tracing
        except ImportError:
            snap = None
        else:
            snap = tracing.snapshot()
        _last[:] = [run, snap]
    return _last[1]


def _ring(run) -> dict | None:
    snap = snapshot(run)
    if snap is None or not snap.frames:
        return None
    return max(snap.frames.values(), key=lambda f: len(f["seq"]))


def frames(run) -> dict | None:
    recs = _ring(run)
    if recs is None:
        return None
    n = run.reading.frames
    seq = recs["seq"][-n:]
    if len(seq) < n or seq[-1] - seq[0] != n - 1:
        return None
    return {k: v[-n:] for k, v in recs.items()}


def window(run) -> tuple[int, int] | None:
    f = frames(run)
    if f is None:
        return None
    first = int(f["seq"][0])
    return first - run.window.frames, first - 1


def records(run, lo: int, hi: int) -> dict | None:
    recs = _ring(run)
    if recs is None:
        return None
    keep = (recs["seq"] >= lo) & (recs["seq"] <= hi)
    return {k: v[keep] for k, v in recs.items()} if keep.any() else None


def window_records(run) -> dict | None:
    w = window(run)
    return None if w is None else records(run, *w)


def mark_interval_ms(run, a: str, b: str) -> float | None:
    """Mean ms a frame of the untraced window from mark a to mark b."""
    f = window_records(run)
    if f is None:
        return None
    t = f["t_ns"]
    return float(np.mean(t[:, MARKS.index(b)] - t[:, MARKS.index(a)])) / 1e6


def between_frames_ms(run) -> float | None:
    """Mean ms from a frame's last mark to the next frame's first, over the
    untraced window's frames whose next frame the window holds too."""
    f = window_records(run)
    if f is None:
        return None
    seq, t = f["seq"], f["t_ns"]
    nxt = np.flatnonzero(seq[1:] == seq[:-1] + 1)
    return float(np.mean(t[nxt + 1, 0] - t[nxt, -1])) / 1e6 if len(nxt) else None


def spans(run) -> dict | None:
    snap = snapshot(run)
    return None if snap is None else snap.spans


def frame_spans(run, name: str, lo: int, hi: int) -> dict | None:
    """The closed spans ``name`` begun in frames lo..hi (their ``frame``);
    None with none."""
    s = spans(run)
    if s is None:
        return None
    sel = (s["name"] == name) & (s["frame"] >= lo) & (s["frame"] <= hi) & (s["end_ns"] >= 0)
    if not sel.any():
        return None
    return {k: v[sel] for k, v in s.items()}


def window_span_ms(run, name: str) -> float | None:
    """Mean ms of the spans ``name`` of the untraced window's frames."""
    w = window(run)
    got = None if w is None else frame_spans(run, name, *w)
    return None if got is None else float(np.mean(got["end_ns"] - got["start_ns"])) / 1e6


def setup_span_s(run, name: str, parent: str | None = None) -> float | None:
    """The last closed span ``name`` (whose parent is a ``parent`` span,
    where given), in seconds: the run's set-up, which comes after any
    earlier run's in one process."""
    s = spans(run)
    if s is None:
        return None
    sel = (s["name"] == name) & (s["end_ns"] >= 0)
    if parent is not None:
        sel &= np.isin(s["parent"], s["id"][s["name"] == parent])
    if not sel.any():
        return None
    i = int(np.flatnonzero(sel)[-1])
    return float(s["end_ns"][i] - s["start_ns"][i]) / 1e9
