"""The program's trace: host spans, device stage marks and per-frame counters.

Everything lives in rings allocated once for the process; nothing is
exported. ``snapshot()`` is the one read: the rings as arrays, the device's
times mapped onto the host's clock (time.perf_counter_ns).

Spans. A span is a named interval of the host's work on
time.perf_counter_ns: ``t = FRAME.begin()`` ... ``FRAME.end(t)``; where one
span follows another, ``t = A.then(t, B)`` ends A and begins B on one
reading of the clock. It records
its id, name, parent (the innermost span open when it began, -1 for none),
frame (the sequence number of the last frame enqueued when it ended: a
``frame`` span's own frame) and its start and end, as integers written into
a preallocated ring (a list, whose stores cost half an array's): a span
allocates nothing but the clock's integers. Per-frame spans and set-up spans keep rings of their own,
so that a long loop does not push the set-up out. Spans nest on one thread,
the frame loop's.

  frame          Renderer.render_with_uniforms, to the frame enqueued
  present.wait   Presenter: the wait for the copy of the frame handed out
  present.copy   Presenter: that frame copied out of pinned memory
  setup.scene    device/scene.py build_scene, every scene loader's shared path
  setup.upload   device/scene.py upload, the quad rows included
  setup.capture  graphs.Graph: the first, eager call (with the kernels'
                 build) and the capture

Marks. The ``FrameMarks`` of a device (``marks(device)``) places render_frame's
seven marks (MARKS): the frame's start, and the end of geometry (transform
and triangle setup), binning, raster, the pack, shading and the encode. On a
CUDA device a mark is %globaltimer written into the frame's record
(csrc/trace.cu). Marks 0, 1 and 6 are trace.cu's one-thread kernel, a node
of the frame's CUDA graph in stream order (``mark``); marks 2 to 5 fall
where a hand-written kernel starts or ends (raster's start and end, the
first shading kernel's start, the last one's end), and that kernel stamps
them (``stamps``), so that they add no node to the frame's path. The first
mark advances a sequence counter on the device; the last copies the record,
with the frame's bin_overflow and window_miss_px, into a ring in mapped host
memory and then marks it whole. The host counts the frames it enqueues in
the same stream order (``enqueued``): placing mark 0 counts one, and a
graph's replay counts what its capture placed (graphs.py, as with
kernels.LAUNCHES), so a frame's host and device sequence numbers agree
whoever calls the frame function. On the CPU, and under
kernels.plain_kernels(), every mark is placed by ``mark`` (on the CPU
time.perf_counter_ns, written by the host). The host reads records as they
stand, with no synchronize and no copy: a record is there once the card has
finished the frame (``counters``, ``snapshot``).

Clock. A calibration launches a mark right after a synchronize and reads the
host's clock before the launch and after a second synchronize; of
CALIBRATIONS tries it keeps the shortest round trip, its midpoint beside the
mark's %globaltimer. A Renderer calibrates after its first frame (its graph
captured, the kernels built) and every snapshot() again; a device time maps
onto the host's clock by the offset interpolated between calibrations.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

from tpurast_torch import kernels
from tpurast_torch.kernels import _build

#: The marks of a frame, each named by the stage it ends ("start": none).
MARKS = ("start", "geometry", "binning", "raster", "pack", "shading", "encode")
#: The marks a hand-written kernel stamps on a CUDA device (FrameMarks.stamps).
STAMPED = (2, 3, 4, 5)
#: int64 words of a frame record: 0 sequence number, 1..7 the marks' times,
#: OVERFLOW and MISS the frame's counters, DONE the sequence number once
#: the record is whole (csrc/trace.cu).
SLOT = 16
OVERFLOW, MISS, DONE = 8, 9, 10
FRAME_SLOTS = 4096
FRAME_SPANS = 1 << 16
SETUP_SPANS = 1024
CALIBRATIONS = 8
_FIELDS = 6  # a span's words: id, name, parent, frame, start, end

_names: list[str] = []
_now = time.perf_counter_ns
_last_id = 0
_open_id = -1  # the innermost open span; each span's row holds the one it was opened in
_frame = 0


class SpanRing:
    """The last ``capacity`` spans (a power of two), _FIELDS words each."""

    def __init__(self, capacity: int):
        if capacity < 1 or capacity & (capacity - 1):
            raise ValueError(f"a span ring's capacity must be a power of two, got {capacity}")
        self.mask = capacity - 1
        self.rows = [0] * (_FIELDS * capacity)

    def arrays(self) -> dict:
        """The spans held, oldest first: int64 arrays id, name (codes),
        parent, frame, start_ns, end_ns (-1 while open)."""
        rows = np.array(self.rows, dtype=np.int64).reshape(-1, _FIELDS)
        rows = rows[rows[:, 0] > 0]
        rows = rows[np.argsort(rows[:, 0], kind="stable")]
        return dict(zip(("id", "name", "parent", "frame", "start_ns", "end_ns"), rows.T.copy()))


class Span:
    """A span name bound to its ring: begin() -> id, end(id) -> its ns."""

    __slots__ = ("name", "code", "rows", "mask")

    def __init__(self, name: str, ring: SpanRing):
        self.name, self.code, self.rows, self.mask = name, len(_names), ring.rows, ring.mask
        _names.append(name)

    def begin(self, t: int | None = None) -> int:
        global _last_id, _open_id
        n = _last_id = _last_id + 1
        i = (n & self.mask) * _FIELDS
        self.rows[i : i + _FIELDS] = (n, self.code, _open_id, -1, _now() if t is None else t, -1)
        _open_id = n
        return n

    def end(self, n: int) -> int:
        """Close span n (a span opened inside it and left open stays open);
        returns its length in ns, -1 where the ring has overwritten it."""
        t = _now()
        global _open_id
        rows = self.rows
        i = (n & self.mask) * _FIELDS
        if rows[i] != n:
            _open_id = -1
            return -1
        _open_id = rows[i + 2]
        rows[i + 3] = _frame
        rows[i + 5] = t
        return t - rows[i + 4]

    def then(self, n: int, span: "Span") -> int:
        """End span n and begin ``span`` at the same time: its id."""
        t = _now()
        global _open_id
        rows = self.rows
        i = (n & self.mask) * _FIELDS
        if rows[i] == n:
            _open_id = rows[i + 2]
            rows[i + 3] = _frame
            rows[i + 5] = t
        else:
            _open_id = -1
        return span.begin(t)


_frame_spans = SpanRing(FRAME_SPANS)
_setup_spans = SpanRing(SETUP_SPANS)
FRAME = Span("frame", _frame_spans)
PRESENT_WAIT = Span("present.wait", _frame_spans)
PRESENT_COPY = Span("present.copy", _frame_spans)
SETUP_SCENE = Span("setup.scene", _setup_spans)
SETUP_UPLOAD = Span("setup.upload", _setup_spans)
SETUP_CAPTURE = Span("setup.capture", _setup_spans)


class FrameMarks:
    """The frame records of one device: render_frame's marks (``mark``), the
    host's count of frames enqueued (``enqueued``, ``count``), the counters
    of finished frames (``counters``) and the clock's calibrations (module
    docstring).
    On a CUDA device the ring and the device's counter are allocated at the
    first mark, so that the kernels' build falls in the first frame."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slots = FRAME_SLOTS
        self.enqueued = 0
        self.calibrations: list[tuple[int, int, int]] = []  # (device ns, host ns, round trip ns)
        self._ring = self._seq = self._frame = None
        self.records = None if self.cuda else np.zeros((self.slots + 1, SLOT), dtype=np.int64)

    def _allocate(self) -> None:
        n = (self.slots + 1) * SLOT
        host, self._ring = _build.host_mapped(8 * n)
        self.records = np.ctypeslib.as_array((ctypes.c_longlong * n).from_address(host)).reshape(self.slots + 1, SLOT)
        self._seq = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._frame = torch.zeros(SLOT, dtype=torch.int64, device=self.device)  # the record in flight
        self._words = [self._frame[1 + i] for i in range(len(MARKS))]

    def _launch(self, i: int, last: bool, overflow=None, miss=None) -> None:
        if self._ring is None:
            self._allocate()
        _build.call("tr_trace_mark", self._ring, self._seq, self._frame, self.slots, i, int(last), overflow, miss)

    def _kernels_stamp(self) -> bool:
        return self.cuda and not kernels.plain_kernels_active()

    def stamps(self, start: int | None = None, end: int | None = None) -> tuple:
        """(start, end): the words of the frame's record in flight that a
        hand-written kernel stamps with marks ``start`` and ``end`` of
        STAMPED at its start and its end (0-dim int64 tensors, None for
        none); (None, None) where no kernel stamps, and ``mark`` places
        them."""
        if not self._kernels_stamp():
            return None, None
        if self._ring is None:
            self._allocate()
        return tuple(None if i is None else self._words[i] for i in (start, end))

    def mark(self, i: int, overflow=None, miss=None) -> None:
        """Mark i of MARKS for the frame in flight; the last mark takes the
        frame's bin_overflow and window_miss_px (0-dim int32 tensors). A
        mark of STAMPED that a kernel stamps places nothing here."""
        last = i == len(MARKS) - 1
        if i == 0:
            self.count(1)
        if self.cuda:
            if i not in STAMPED or not self._kernels_stamp():
                self._launch(i, last, overflow, miss)
            return
        t = time.perf_counter_ns()
        s = self.enqueued
        rec = self.records[s % self.slots]
        if i == 0:
            rec[DONE] = 0
            rec[0] = s
        rec[1 + i] = t
        if last:
            rec[OVERFLOW] = 0 if overflow is None else int(overflow)
            rec[MISS] = 0 if miss is None else int(miss)
            rec[DONE] = s

    def count(self, n: int) -> None:
        """Count n frames enqueued (negative: take back what a capture placed)."""
        global _frame
        self.enqueued += n
        _frame = self.enqueued

    def counters(self, seq: int):
        """(bin_overflow, window_miss_px) of frame ``seq`` once the device
        has finished it, else None. Waits for nothing."""
        if self.records is None:
            return None
        rec = self.records[seq % self.slots]
        if rec[DONE] != seq:
            return None
        return int(rec[OVERFLOW]), int(rec[MISS])

    def calibrate(self) -> None:
        """Pair the device's clock with the host's (module docstring)."""
        if not self.cuda:
            return
        best = None
        for _ in range(CALIBRATIONS):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            self._launch(-1, False)
            torch.cuda.synchronize(self.device)
            h1 = time.perf_counter_ns()
            if best is None or h1 - h0 < best[2]:
                best = (int(self.records[self.slots, 0]), (h0 + h1) // 2, h1 - h0)
        self.calibrations.append(best)

    def frames(self) -> dict:
        """The whole records held, by sequence number: seq (n,), t_ns (n, 7)
        on the host's clock, overflow (n,), miss (n,)."""
        if self.records is None:
            rows = np.zeros((0, SLOT), dtype=np.int64)
        else:
            rows = np.array(self.records[: self.slots])
            rows = rows[(rows[:, 0] > 0) & (rows[:, DONE] == rows[:, 0])]
            rows = rows[np.argsort(rows[:, 0])]
        t = rows[:, 1 : 1 + len(MARKS)]
        if self.cuda and len(t):
            t = to_host_clock(t, self.calibrations)
        return dict(seq=rows[:, 0].copy(), t_ns=t.copy(), overflow=rows[:, OVERFLOW].copy(), miss=rows[:, MISS].copy())


def to_host_clock(t_dev, calibrations) -> np.ndarray:
    """Device ns (any shape, int64) on time.perf_counter_ns: t + the
    calibrations' offset (host - device), interpolated linearly in device
    time between calibrations and held beyond the first and the last."""
    t_dev = np.asarray(t_dev, dtype=np.int64)
    if not calibrations:
        raise ValueError("no calibration: the device's clock cannot be mapped")
    cal = np.array(sorted(c[:2] for c in calibrations), dtype=np.int64)
    d0, off0 = cal[0, 0], cal[0, 1] - cal[0, 0]
    off = np.interp((t_dev - d0).astype(np.float64), (cal[:, 0] - d0).astype(np.float64),
                    (cal[:, 1] - cal[:, 0] - off0).astype(np.float64))
    return t_dev + off0 + np.rint(off).astype(np.int64)


def stage_ms(frames: dict, first: int, last: int) -> dict:
    """{stage: mean ms} of each stage MARKS name over the records of frames
    first..last (FrameMarks.frames())."""
    keep = (frames["seq"] >= first) & (frames["seq"] <= last)
    steps = np.diff(frames["t_ns"][keep], axis=1) / 1e6
    return {name: float(steps[:, i].mean()) for i, name in enumerate(MARKS[1:])}


_marks: dict[torch.device, FrameMarks] = {}


def enqueued() -> dict:
    """{FrameMarks: frames counted so far} of every device."""
    return {m: m.enqueued for m in _marks.values()}


def marks(device) -> FrameMarks:
    """The process's FrameMarks of ``device``, made at first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _marks:
        _marks[device] = FrameMarks(device)
    return _marks[device]


@dataclasses.dataclass
class Snapshot:
    """The trace as it stands. spans: int64 arrays id, parent, frame,
    start_ns, end_ns and the str array name, oldest first, both rings;
    frames: FrameMarks.frames() by device ("cuda:0", "cpu");
    calibrations: (k, 3) int64 arrays (device ns, host ns, round trip ns)
    by device."""

    spans: dict
    frames: dict
    calibrations: dict


def snapshot() -> Snapshot:
    """Calibrate every CUDA device's clock once more and read the rings."""
    for m in _marks.values():
        if m.records is not None:
            m.calibrate()
    parts = [r.arrays() for r in (_setup_spans, _frame_spans)]
    spans = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    order = np.argsort(spans["id"], kind="stable")
    spans = {k: v[order] for k, v in spans.items()}
    spans["name"] = np.array(_names, dtype=object)[spans["name"]]
    return Snapshot(
        spans=spans,
        frames={str(d): m.frames() for d, m in _marks.items()},
        calibrations={str(d): np.array(m.calibrations, dtype=np.int64).reshape(-1, 3) for d, m in _marks.items()},
    )
