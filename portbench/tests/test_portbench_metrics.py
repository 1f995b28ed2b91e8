"""The metric readers' arithmetic on planted windows and traces."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import loops, run, trace
from portbench.run import Run


def _window(intervals, frames=None, render_host=0.5, present_host=None):
    iv = np.asarray(intervals, dtype=float)
    return loops.Window(frames=len(iv) if frames is None else frames, seconds=iv.sum() / 1e3, intervals_ms=iv,
                        render_host_ms=render_host, present_host_ms=present_host, overflow=[], sample=[])


def test_frame_ms_is_the_whole_window_over_its_frames():
    w = _window([2.0] * 99 + [26.9])  # one stall in a hundred frames
    r = Run(setup_s=30.0, window=w, reading=None)
    assert run.reader("frame_ms").read(r) == pytest.approx((99 * 2.0 + 26.9) / 100)
    assert run.reader("present_frame_ms").read(r) == pytest.approx((99 * 2.0 + 26.9) / 100)
    assert run.reader("setup_s").read(r) == 30.0


@pytest.mark.parametrize("name", ["frame_p95_ms", "present_p95_ms"])
def test_p95_sees_stalls_a_mean_hides(name):
    steady = _window([2.0] * 100)
    stalls = _window([2.0] * 90 + [20.0] * 10)
    assert run.reader(name).read(Run(0.0, steady, None)) == pytest.approx(2.0)
    assert run.reader(name).read(Run(0.0, stalls, None)) == pytest.approx(20.0)
    one = _window([2.0] * 99 + [26.9])  # one stall is under the 95th percentile
    assert run.reader(name).read(Run(0.0, one, None)) == pytest.approx(2.0)


def test_reservoir_is_uniform_and_seeded():
    picks = []
    for seed in range(400):
        r = loops.Reservoir(2, seed)
        for k in range(10):
            r.offer(k)
        picks += r.items
    counts = np.bincount(picks, minlength=10)
    assert counts.min() > 40 and counts.max() < 120  # 80 each expected
    a, b = loops.Reservoir(3, 7), loops.Reservoir(3, 7)
    for k in range(1000):
        a.offer(k)
        b.offer(k)
    assert a.items == b.items


def _reading(loop="render"):
    # Two frames: kernels with a gap of 10 us (render_call open) and 5 us (harness).
    dev = [("void raster_kernel(int)", 0.0, 10.0), ("void at::native::vectorized_elementwise_kernel<4>", 10.0, 20.0),
           ("void plan_kernel<true>(float const*)", 40.0, 5.0), ("void sample_kernel(int)", 45.0, 5.0),
           ("Memcpy DtoD (Device -> Device)", 55.0, 5.0)]
    spans = [("uniforms", 25.0, 28.0), ("render_call", 28.0, 45.0), ("present", 60.0, 70.0)]
    layers = {"raster": ["raster_kernel"], "plan": ["plan_kernel"], "sample": ["sample_kernel"]}
    return trace.read(dev, spans, 2, layers, loop, {"raster": 0.002, "sample": 0.001})


def test_trace_reading_by_layer_and_idle_gaps():
    r = _reading()
    assert r.busy_s == pytest.approx(45e-6) and r.window_s == pytest.approx(60e-6)
    assert r.layer_ms == {"raster": pytest.approx(0.005), "plan": pytest.approx(0.0025),
                          "sample": pytest.approx(0.0025)}
    assert r.other_ms == pytest.approx(0.0125)
    assert dict((n, v) for n, v in r.idle_gaps) == {"render_call": pytest.approx(10e-6),
                                                     "harness": pytest.approx(5e-6)}
    assert r.device_ops[0][0].startswith("void at::native")
    ctx = Run(0.0, _window([1.0]), r)
    assert run.reader("device_idle_pct").read(ctx) == pytest.approx(25.0)
    assert run.reader("device_idle_pct.present").read(ctx) is None
    assert run.reader("raster_roofline_pct").read(ctx) == pytest.approx(40.0)
    assert run.reader("sample_roofline_pct").read(ctx) == pytest.approx(40.0)
    assert run.reader("deferred_roofline_pct").read(ctx) is None  # no such kernel: no reading, never 0
    assert run.reader("torch_ops_ms").read(ctx) == pytest.approx(0.0125)


def test_present_readers_read_the_present_loop():
    r = _reading("present")
    ctx = Run(0.0, _window([3.0], render_host=0.4, present_host=2.2), r)
    assert run.reader("device_idle_pct.present").read(ctx) == pytest.approx(25.0)
    assert run.reader("device_idle_pct").read(ctx) is None
    assert run.reader("present_host_ms").read(ctx) == 2.2
    assert run.reader("render_host_ms").read(ctx) == 0.4


def test_kernel_ids():
    assert trace.kernel_id("void plan_kernel<true>(int, float*)") == "plan_kernel"
    assert trace.kernel_id("raster_units_kernel(int const*, int)") == "raster_units_kernel"
    assert trace.kernel_id("void at::native::elementwise_kernel<128, 2>(int)") == "elementwise_kernel"
    assert trace.kernel_id("(anonymous namespace)::raster_kernel(float const*, int)") == "raster_kernel"
    assert trace.kernel_id("void (anonymous namespace)::shade_deferred_kernel<1>(float const*)") == \
        "shade_deferred_kernel"
    assert trace.kernel_id("Memcpy DtoH (Device -> Pinned)") == "DtoH"
