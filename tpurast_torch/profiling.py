"""Per-stage timing of the production frame path.

Counterpart of tpurast/profiling.py: ``stage_sweep`` times PREFIXES of
render_frame through its ``stage=`` parameter, so the differences between
successive prefixes are per-stage costs on the exact production path. A
prefix ends in its probe, a sum over the stage's outputs. On a CUDA device
each prefix is a CUDA graph of its own (graphs.FrameGraph), as the
reference jit-compiles each one, captured in its first warm-up call and
dropped once timed; on the CPU it runs eagerly. Frames are timed in
groups: on a CUDA device a group is bracketed by two CUDA events on the
current stream and one synchronize, so the time is the device's, launch
gaps included; on the CPU by time.perf_counter. Used by
``python -m tpurast_torch.cli --stages`` (stage_ms in the bench line).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from tpurast_torch.graphs import FrameGraph, graph_wanted
from tpurast_torch.renderer import render_frame

#: Prefix order; None = the full frame (shade + sRGB encode).
STAGES = [
    "geometry",
    "binning",
    "segments",
    "raster",
    "resolve",
    "plan",
    "sample",
    None,
]


def time_groups(fn, scene, uniforms, group: int = 16, after_group=None) -> list[float]:
    """Per-frame ms of each group of up to ``group`` consecutive calls
    fn(scene, *u), u in uniforms. On a CUDA scene: CUDA events around the
    group on the current stream, one synchronize per group. On the CPU: the
    host's clock. ``after_group(out)`` is called with each group's last
    result once the group has finished, outside the timed span."""
    device = scene["corner_world"].device
    on_card = device.type == "cuda"
    times = []
    for g in range(0, len(uniforms), group):
        batch = uniforms[g : g + group]
        out = None
        if on_card:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        for u in batch:
            out = fn(scene, *u)
        if on_card:
            stop.record(torch.cuda.current_stream(device))
            stop.synchronize()
            times.append(start.elapsed_time(stop) / len(batch))
        else:
            times.append((time.perf_counter() - t0) * 1e3 / len(batch))
        if after_group is not None:
            after_group(out)
    return times


def time_grouped(fn, scene, uniforms, warmup=4, frames=32, group=16):
    """p50 per-frame ms of fn(scene, *u) over ``frames`` calls after
    ``warmup`` untimed ones, timed in groups of ``group`` (time_groups)."""
    for u in uniforms[:warmup]:
        fn(scene, *u)
    times = time_groups(fn, scene, uniforms[warmup : warmup + frames], group)
    return float(np.percentile(np.asarray(times), 50))


def stage_sweep(renderer, uniforms, frames=32, group=16, warmup=4):
    """p50 ms for each pipeline prefix of `renderer`'s config, each over
    ``frames`` frames after ``warmup`` untimed ones.

    Returns (cum, delta): cumulative ms per prefix and per-stage deltas
    keyed by stage name ("frame" = the full pipeline). Stages that don't
    exist under the renderer's config (resolve on the deferred path,
    plan/sample on the gather paths) are skipped. "segments" repeats the
    binning prefix (the port has no segment schedule), so its delta is the
    spread between two timings of the same work.
    """
    kw = renderer._frame_kwargs
    stages = [
        s
        for s in STAGES
        if not (s == "resolve" and kw["shading"] != "forward")
        and not (s in ("plan", "sample") and renderer.sampler != "window")
    ]
    cum = {}
    delta = {}
    prev = 0.0
    for s in stages:
        fn = functools.partial(render_frame, **kw, stage=s)
        if graph_wanted(renderer.device):
            fn = FrameGraph(fn, name=f"stage {s or 'frame'}")
        try:
            ms = time_grouped(fn, renderer.scene, uniforms, warmup=warmup, frames=frames, group=group)
        finally:
            if isinstance(fn, FrameGraph):
                fn.close()
        name = s or "frame"
        cum[name] = round(ms, 3)
        delta[name] = round(ms - prev, 3)
        prev = ms
    return cum, delta
