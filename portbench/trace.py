"""The device trace of a traced run: a slice of frames under torch.profiler.

After the timed window, a traced run renders ``frames`` more frames of the
same loop under the profiler, tracing the card's activity only (recording
the host's operations too slows the host past the card's pace and idles
it). The harness's host spans (uniforms, render_call, present,
counter_read) are taken on the host's clock and put on the trace's clock
by a marker: one small kernel launched right after a synchronize, before
the slice. The profile is exported as a Chrome trace into the checkout's
cache and read back: every kernel, copy and set the card ran, with its
start and length.
A profile that records no device activity, which torch.profiler does now
and then, is taken again, up to four times (chip_smoke.py's
device_ms_retried). The run makes no other Renderer and destroys no CUDA
graph before the profile has been read: destroying one before a replay
is profiled crashes the profiler (tpurast_torch/tools/profiler_graph_crash.py).

``Reading`` is what the per-layer metric readers (portbench/metrics/) see.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import time

import numpy as np

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
TRIES = 4


def kernel_id(name: str) -> str:
    """A kernel's identifier without its return type, namespaces, template
    arguments and parameters ("void (anonymous namespace)::plan_kernel<true>(int, ...)"
    -> "plan_kernel")."""
    head = re.split(r"[(<]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0].split()
    return head[-1].split("::")[-1] if head else name


@dataclasses.dataclass
class Reading:
    loop: str  # "render" or "present"
    frames: int  # frames in the traced slice
    busy_s: float  # union of the device intervals
    window_s: float  # from the slice's first device activity to its last
    layer_ms: dict  # the port's kernels' device ms per frame, by layer (kernels.json)
    other_ms: float  # every other device activity (torch operations, copies), ms per frame
    bounds: dict  # mean bound ms of each kernel over the reference's frames (yardstick.BOUNDS)
    device_ops: list  # [[name, seconds]] the ten device operations that took most time
    idle_gaps: list  # [[host span open, seconds]] idle time by what the host was doing


def _device_events(path: str) -> list:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(dev, key=lambda d: d[1])


def profile(run_slice, path: str, device):
    """run_slice(span) under torch.profiler: its device events (the marker
    left out) and its host spans on the trace's clock, in microseconds;
    taken again while the profiler saw nothing but the marker."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(TRIES):
        spans = []

        @contextlib.contextmanager
        def span(name):
            t = time.perf_counter_ns()
            yield
            spans.append((name, t, time.perf_counter_ns()))

        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(device)
            t_mark = time.perf_counter_ns()
            torch.ones(1, device=device)
            run_slice(span)
            torch.cuda.synchronize(device)
        prof.export_chrome_trace(path)
        dev = _device_events(path)
        os.remove(path)
        if len(dev) > 1:
            mark = dev[0][1]
            return dev[1:], [(n, mark + (a - t_mark) / 1e3, mark + (b - t_mark) / 1e3) for n, a, b in spans]
    return [], []


def read(dev: list, spans: list, frames: int, layers: dict, loop: str, bounds: dict) -> Reading:
    """The slice's device time by layer and by operation, its busy and idle
    time, and the idle time by the host span open when each gap began."""
    of_kernel = {k: layer for layer, names in layers.items() for k in names}
    starts = np.array([d[1] for d in dev])
    ends = np.array([d[1] + d[2] for d in dev])
    order = np.argsort(starts)
    starts, ends = starts[order], ends[order]
    busy, gaps = 0.0, []
    cur_s, cur_e = starts[0], ends[0]
    for s, e in zip(starts[1:], ends[1:]):
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = float(ends.max() - starts[0])
    by_layer, other, by_op = {}, 0.0, {}
    for name, _, dur in dev:
        layer = of_kernel.get(kernel_id(name))
        if layer is None:
            other += dur
        else:
            by_layer[layer] = by_layer.get(layer, 0.0) + dur
        by_op[name] = by_op.get(name, 0.0) + dur
    span_starts = np.array([s[1] for s in spans])
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        i = int(np.searchsorted(span_starts, g0, side="right")) - 1
        name = spans[i][0] if i >= 0 and spans[i][2] >= g0 else "harness"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return Reading(
        loop=loop, frames=frames, busy_s=busy * 1e-6, window_s=window * 1e-6,
        layer_ms={k: v * 1e-3 / frames for k, v in by_layer.items()}, other_ms=other * 1e-3 / frames,
        bounds=bounds, device_ops=[[n, v * 1e-6] for n, v in top],
        idle_gaps=[[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])][:10],
    )
