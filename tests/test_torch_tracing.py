"""The program's trace (tpurast_torch/tracing.py) on the CPU.

  * the span rings: nesting and parent ids, each span's frame sequence
    number, wrap-around (the last ``capacity`` spans kept), no growth of
    memory over many frames, the set-up spans of a scene build and an
    upload, a graph's capture_ms read from its capture span; one
    ``setup.face_tables`` span a Renderer, inside its upload, however many
    frames it renders;
  * the seven marks of render_frame in stage order on the forward-window,
    gather and deferred paths, inside the frame's ``frame`` span, their
    intervals summing to the frame; the host's count of frames enqueued
    equal to the records' sequence numbers; marks refused with a stage=
    prefix or the gbuf output;
  * the clock mapping's arithmetic on planted calibration pairs;
  * frames of the traced Renderer and of render_frame(..., marks=...)
    equal to render_frame without marks bit for bit; a G-buffer Renderer
    records nothing;
  * the counter ring carrying a planted bin_overflow and window_miss_px,
    and the Engine accounting them from it without a synchronize, to the
    frame that carried them; the bench's --stages from the marks.

On the CPU a mark is the host's time.perf_counter_ns; the card's mark
kernel runs under the host emulation in tests/test_torch_csrc.py.
"""

import dataclasses
import json
import logging
import time
import tracemalloc

import numpy as np
import pytest
import torch

from tpurast_torch import cli, graphs, tracing
from tpurast_torch.config import RendererConfig
from tpurast_torch.device import scene as scene_mod
from tpurast_torch.device.scene import build_orbit_scene, orbit_track
from tpurast_torch.engine import Engine
from tpurast_torch.renderer import Renderer, render_frame
from test_torch_scene import numpy_bc_decoders  # noqa: F401  (module-wide autouse)

TINY = dict(floor_quads=8, spheres=1, rings=8, segments=8, tex_size=32, n_textures=2)
CFG = RendererConfig(width=128, height=64)
PATHS = {"window": {}, "gather": dict(sampler="gather"), "deferred": dict(shading="deferred")}


@pytest.fixture(scope="module")
def scene():
    return build_orbit_scene(seed=1, **TINY)


@pytest.fixture(scope="module")
def cams():
    return orbit_track(8)


def _spans_since(first_id: int) -> dict:
    s = tracing.snapshot().spans
    keep = s["id"] > first_id
    return {k: v[keep] for k, v in s.items()}


def _last_id() -> int:
    return tracing._last_id


# ---------------------------------------------------------------------------
# Spans.


def test_spans_nest_with_parent_ids_and_carry_the_frame():
    ring = tracing.SpanRing(16)
    outer, inner = tracing.Span("test.outer", ring), tracing.Span("test.inner", ring)
    m = tracing.FrameMarks("cpu")
    m.count(1)
    seq = m.enqueued
    a = outer.begin()
    b = inner.begin()
    c = inner.begin()
    assert inner.end(c) >= 0 and inner.end(b) >= 0
    d = inner.begin()
    inner.end(d)
    assert outer.end(a) >= 0
    e = inner.begin()  # after the outer span: no parent
    inner.end(e)
    got = ring.arrays()
    assert got["id"].tolist() == [a, b, c, d, e]
    assert got["parent"].tolist() == [-1, a, b, a, -1]
    assert (got["frame"] == seq).all()
    assert (got["end_ns"] >= got["start_ns"]).all()
    assert got["start_ns"][1] >= got["start_ns"][0] and got["end_ns"][0] >= got["end_ns"][3]


def test_a_span_left_open_by_an_exception_is_closed_with_its_parent():
    ring = tracing.SpanRing(8)
    outer, inner = tracing.Span("test.outer", ring), tracing.Span("test.inner", ring)
    a = outer.begin()
    inner.begin()  # never ended
    outer.end(a)
    b = inner.begin()
    inner.end(b)
    got = ring.arrays()
    assert got["parent"][-1] == -1 and got["end_ns"][1] == -1  # the open span reads as open


def test_then_ends_a_span_and_begins_the_next_at_one_time():
    ring = tracing.SpanRing(8)
    outer, a, b = (tracing.Span(f"test.{n}", ring) for n in ("outer", "a", "b"))
    o = outer.begin()
    x = a.begin()
    y = a.then(x, b)
    b.end(y)
    outer.end(o)
    got = ring.arrays()
    assert got["id"].tolist() == [o, x, y] and got["parent"].tolist() == [-1, o, o]
    assert got["end_ns"][1] == got["start_ns"][2] and got["end_ns"][0] >= got["end_ns"][2]


def test_the_ring_keeps_the_last_spans_and_wraps():
    ring = tracing.SpanRing(8)
    span = tracing.Span("test.wrap", ring)
    ids = []
    for _ in range(21):
        n = span.begin()
        span.end(n)
        ids.append(n)
    got = ring.arrays()
    assert got["id"].tolist() == ids[-8:]
    assert span.end(ids[0]) == -1  # overwritten: no length


def test_spans_and_marks_do_not_grow_memory_over_many_frames():
    m = tracing.FrameMarks("cpu")
    before = (len(tracing._frame_spans.rows), m.records.shape)
    zero = torch.zeros((), dtype=torch.int32)
    tracemalloc.start()
    # A slot holds the ints last stored in it: fill the ring under the
    # tracer, so that each int a span stores later frees one it traced.
    for _ in range(tracing.FRAME_SPANS):
        m.count(1)
        tracing.FRAME.end(tracing.FRAME.begin())
    for _ in range(200):  # warm every path
        t = tracing.FRAME.begin()
        for i in range(len(tracing.MARKS)):
            m.mark(i, zero, zero)
        tracing.FRAME.end(t)
    start, _ = tracemalloc.get_traced_memory()
    for _ in range(5000):
        t = tracing.FRAME.begin()
        w = tracing.PRESENT_WAIT.begin()
        tracing.PRESENT_WAIT.end(w)
        for i in range(len(tracing.MARKS)):
            m.mark(i, zero, zero)
        tracing.FRAME.end(t)
    end, _ = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert end - start < 4096
    assert (len(tracing._frame_spans.rows), m.records.shape) == before
    assert m.counters(m.enqueued) == (0, 0)


def test_setup_spans_of_a_scene_build_and_an_upload():
    first = _last_id()
    sc = build_orbit_scene(seed=3, **TINY)
    scene_mod.upload(sc, "cpu")
    got = _spans_since(first)
    assert got["name"].tolist() == ["setup.scene", "setup.upload"]
    assert (got["end_ns"] > got["start_ns"]).all()


@pytest.mark.parametrize("path", list(PATHS))
def test_one_face_tables_span_a_renderer(scene, cams, path):
    """A Renderer builds the face table of its shading path once, inside
    its upload (a ``setup.face_tables`` span whose parent is the
    ``setup.upload`` span), and its frames build none: three frames leave
    exactly one such span. A deferred Renderer's debug_gbuf (a forward
    G-buffer) builds the resolve table at its first call only."""
    first = _last_id()
    r = Renderer(scene, dataclasses.replace(CFG, **PATHS[path]), device="cpu")
    for cam in cams[:3]:
        r.render(cam)
    got = _spans_since(first)
    tables = got["name"] == "setup.face_tables"
    assert int(tables.sum()) == 1
    upload = got["id"][got["name"] == "setup.upload"]
    assert upload.tolist() == got["parent"][tables].tolist()
    want = "shade_table" if path == "deferred" else "resolve_table"
    assert [k for k in ("resolve_table", "shade_table") if k in r.scene] == [want]
    first = _last_id()
    r.debug_gbuf(cams[0])
    r.debug_gbuf(cams[1])
    built = int((_spans_since(first)["name"] == "setup.face_tables").sum())
    assert built == (1 if path == "deferred" else 0) and "resolve_table" in r.scene


def test_capture_ms_is_the_capture_span(monkeypatch):
    g = graphs.Graph(lambda x: x, name="test")
    monkeypatch.setattr(g, "_eager_and_capture", lambda device, fn, inputs: time.sleep(0.002) or "first")
    first = _last_id()
    assert g._capture(None, g.fn, ()) == "first"
    spans = _spans_since(first)
    assert spans["name"].tolist() == ["setup.capture"]
    assert g.capture_ms == (spans["end_ns"][0] - spans["start_ns"][0]) / 1e6 and g.capture_ms >= 2.0


# ---------------------------------------------------------------------------
# Marks.


@pytest.mark.parametrize("path", list(PATHS))
def test_seven_marks_in_stage_order_inside_the_frame_span(scene, cams, path):
    r = Renderer(scene, dataclasses.replace(CFG, **PATHS[path]), device="cpu")
    first_id, first_seq = _last_id(), r.marks.enqueued + 1
    for cam in cams[:3]:
        r.render(cam)
    frames = r.marks.frames()
    keep = frames["seq"] >= first_seq
    seq, t = frames["seq"][keep], frames["t_ns"][keep]
    assert seq.tolist() == list(range(first_seq, r.marks.enqueued + 1)) and len(seq) == 3
    assert t.shape == (3, len(tracing.MARKS))
    steps = np.diff(t, axis=1)
    assert (steps >= 0).all() and (steps.sum(axis=1) == t[:, -1] - t[:, 0]).all()
    assert (t[1:, 0] >= t[:-1, -1]).all()  # one frame after the other
    spans = _spans_since(first_id)
    frame = {k: v[spans["name"] == "frame"] for k, v in spans.items()}
    assert frame["frame"].tolist() == seq.tolist()  # host and device sequence numbers agree
    assert (frame["start_ns"] <= t[:, 0]).all() and (t[:, -1] <= frame["end_ns"]).all()
    assert (frames["overflow"][keep] == 0).all() and (frames["miss"][keep] == 0).all()


def test_the_frame_function_called_directly_counts_its_frames(scene, cams):
    """Mark 0 counts the frame, so a caller of the Renderer's frame function
    (entry.py hands it out) keeps the host's count and the records' sequence
    numbers together, as render does."""
    r = Renderer(scene, CFG, device="cpu")
    fn = r._frame_fn("frame")
    before = r.marks.enqueued
    fn(r.scene, *r.frame_uniforms(cams[0]))
    r.render(cams[1])
    frames = r.marks.frames()
    assert r.marks.enqueued == before + 2 and frames["seq"][-2:].tolist() == [before + 1, before + 2]


def test_on_a_card_the_render_kernels_stamp_four_marks(monkeypatch):
    """A card's FrameMarks launches the mark kernel for marks 0, 1 and 6
    and hands the words of marks 2 to 5 to the render kernels (stamps);
    under kernels.plain_kernels(), where no render kernel runs, it launches
    all seven."""
    from tpurast_torch import kernels

    m = tracing.FrameMarks(torch.device("cuda", 0))
    launched = []
    monkeypatch.setattr(m, "_launch", lambda i, last, overflow=None, miss=None: launched.append((i, last)))
    m._ring, m._words = 1, [torch.tensor(i) for i in range(len(tracing.MARKS))]
    for i in range(len(tracing.MARKS)):
        m.mark(i)
    assert launched == [(0, False), (1, False), (6, True)] and m.enqueued == 1
    assert [int(w) for w in m.stamps(2, 3)] == [2, 3] and m.stamps(None, 5)[0] is None
    launched.clear()
    with kernels.plain_kernels():
        assert m.stamps(2, 3) == (None, None)
        for i in range(len(tracing.MARKS)):
            m.mark(i)
    assert [i for i, _ in launched] == list(range(len(tracing.MARKS)))
    assert tracing.FrameMarks("cpu").stamps(4, 5) == (None, None)


def test_marks_need_a_whole_frame(scene, cams):
    r = Renderer(scene, CFG, device="cpu")
    u = r.frame_uniforms(cams[0])
    for change in (dict(stage="raster"), dict(output="gbuf")):
        with pytest.raises(ValueError, match="whole frame"):
            render_frame(r.scene, *u, **dict(r._frame_kwargs, **change), marks=r.marks)


@pytest.mark.parametrize("path", list(PATHS))
def test_traced_frames_equal_untraced_ones(scene, cams, path):
    cfg = dataclasses.replace(CFG, **PATHS[path])
    r = Renderer(scene, cfg, device="cpu")
    assert r.marks is tracing.marks("cpu")
    u = r.frame_uniforms(cams[2])
    want = render_frame(r.scene, *u, **r._frame_kwargs)
    plain = render_frame(r.scene, *u, **r._frame_kwargs, marks=None)
    marked = render_frame(r.scene, *u, **r._frame_kwargs, marks=tracing.FrameMarks("cpu"))
    for got in (plain, marked, r.render(cams[2])):
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_a_gbuf_renderer_records_nothing(scene, cams):
    g = Renderer(scene, CFG, "gbuf", device="cpu")
    assert g.marks is None
    first_id, enqueued = _last_id(), tracing.marks("cpu").enqueued
    assert set(g.render(cams[1])) == {"gbuf", "depth", "fid"}
    assert _last_id() == first_id and tracing.marks("cpu").enqueued == enqueued


# ---------------------------------------------------------------------------
# Clock.


def test_clock_mapping_on_planted_calibrations():
    g0 = 1_700_000_000_000_000_000  # %globaltimer reads ns since the epoch
    cal = [(g0, 5_000, 10), (g0 + 1_000_000, 1_005_100, 10)]  # the host gained 100 ns in 1 ms
    t = np.array([g0, g0 + 500_000, g0 + 1_000_000, g0 - 1_000, g0 + 2_000_000], dtype=np.int64)
    got = tracing.to_host_clock(t, cal)
    assert got.tolist() == [5_000, 505_050, 1_005_100, 4_000, 2_005_100]  # held beyond the ends
    assert tracing.to_host_clock(t[:1], cal[:1]).tolist() == [5_000]  # one calibration: an offset
    assert tracing.to_host_clock(t.reshape(5, 1), list(reversed(cal))).shape == (5, 1)
    with pytest.raises(ValueError, match="calibration"):
        tracing.to_host_clock(t, [])


def test_cpu_marks_need_no_calibration():
    m = tracing.FrameMarks("cpu")
    m.calibrate()
    assert m.calibrations == []


# ---------------------------------------------------------------------------
# The counter ring.


def _frame(m: tracing.FrameMarks, overflow: int, miss: int) -> int:
    for i in range(len(tracing.MARKS) - 1):
        m.mark(i)
    m.mark(len(tracing.MARKS) - 1, torch.tensor(overflow, dtype=torch.int32), torch.tensor(miss, dtype=torch.int32))
    return m.enqueued


def test_the_counter_ring_carries_planted_counters():
    m = tracing.FrameMarks("cpu")
    a, b = _frame(m, 7, 3), _frame(m, 0, 12)
    assert m.counters(a) == (7, 3) and m.counters(b) == (0, 12)
    assert m.counters(b + 1) is None  # not yet rendered
    m.mark(0)
    seq = m.enqueued
    assert m.counters(seq) is None  # in flight: no record yet
    five = torch.tensor(5, dtype=torch.int32)
    for i in range(1, len(tracing.MARKS) - 1):
        m.mark(i)
    m.mark(len(tracing.MARKS) - 1, five, five)
    assert m.counters(seq) == (5, 5)
    for _ in range(m.slots):
        _frame(m, 1, 1)
    assert m.counters(a) is None  # its slot has been written again


def test_engine_reads_counters_from_the_counter_ring(scene, monkeypatch, caplog):
    eng = Engine(scene=scene, config=CFG, overlay=False, device="cpu")
    marks = eng.renderer.marks
    planted_seq = marks.enqueued + 2  # the second tick's frame
    last = len(tracing.MARKS) - 1
    real = marks.mark

    def planted(i, overflow=None, miss=None):
        if i == last and marks.enqueued == planted_seq:
            overflow, miss = torch.tensor(7, dtype=torch.int32), torch.tensor(3, dtype=torch.int32)
        real(i, overflow, miss)

    monkeypatch.setattr(marks, "mark", planted)
    with caplog.at_level(logging.WARNING, logger="tpurast_torch.engine"):
        eng.tick()
        assert eng.dropped_total == 0
        eng.tick()  # on the CPU the frame has finished when the tick reads
        assert (eng.dropped_total, eng.overflow_frames, eng.window_miss_total) == (7, 1, 3)
        eng.run(2)
    assert (eng.dropped_total, eng.overflow_frames, eng.window_miss_total) == (7, 1, 3)
    assert eng._counted == marks.enqueued
    assert "frame 1: 7 binned pairs dropped" in caplog.text and "frame 1: 3 pixels" in caplog.text


def test_cli_stages_come_from_the_marks(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(scene_mod, "build_orbit_scene", lambda seed=0, **kw: build_orbit_scene(seed=seed, **TINY))
    monkeypatch.setenv("TPURAST_TORCH_SCENE_CACHE_DIR", str(tmp_path))
    rc = cli.main(["--device", "cpu", "--scene", "orbit", "--width", "128", "--height", "64", "--frames", "3",
                   "--warmup", "1", "--skip-parity-gate", "--stages", "--seed", "1"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and list(res["stage_ms"]) == list(tracing.MARKS[1:])
    assert all(v >= 0 for v in res["stage_ms"].values()) and res["stage_ms"]["raster"] > 0


def test_trace_check_pairs_marks_with_the_profilers_kernels(monkeypatch, capsys):
    """tools/trace_check.py pairs each mark kernel's mark with the
    profiler's start of the same kernel though the profiler dropped some
    (the first among them) and its clock runs at another rate; without a
    card it exits 2."""
    from tpurast_torch.tools import trace_check

    assert trace_check.NODES == (0, 1, 6) and len(trace_check.MARK_EVENTS) == len(tracing.MARKS)
    rng = np.random.default_rng(3)
    steps = np.array([0, 360, 1400], dtype=float)  # marks 0, 1 and 6 of a frame
    mapped = (np.arange(64)[:, None] * 1766.0 + np.cumsum(steps)[None, :]).reshape(-1)
    profiled = mapped * (1 + 28e-6) - 12345.0 + rng.normal(0, 0.1, mapped.size)
    dropped = np.concatenate([[0], rng.choice(np.arange(1, mapped.size), 8, replace=False)])
    kept = np.delete(np.arange(mapped.size), dropped)
    j = trace_check._pair(mapped, profiled[kept])
    assert (kept[j[kept]] == kept).all()  # every mark the profiler kept pairs with its own kernel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trace_check.main([]) == 2 and "no CUDA device" in capsys.readouterr().err
