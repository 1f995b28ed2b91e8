"""The frame trace (tpurast_torch/tracing.py) on the card: its clock, its cost
and what it sees over a window.

    python -m tpurast_torch.tools.trace_check [--scene porsche_class --data-dir DIR --textures 12]
        [--seconds 20] [--out FILE]

The cameras are a viewer's orbit: at --radius about the origin, looking at
it, turned 0.01 rad a frame; each frame's uniforms are made as it is
rendered (Renderer.render), as a viewer makes them. Prints one JSON line a phase (and writes every
phase, the window's blocks included, to --out):

  agreement  a slice of --frames frames of a traced Renderer under
             torch.profiler: each mark's time, mapped onto the host's clock,
             less the profiler's time of the same point (MARK_EVENTS: the
             start of a mark kernel, the start or end of a render kernel
             that stamps it), p5, p50, p95 in us, centred on the median,
             with the offset alone and with the profiler's rate fitted too;
             the mark kernels' profiler device us a frame, and the drift
             between the clock's calibrations
  cost       Renderer(trace=True) against trace=False in alternating pairs,
             --rounds of each order, --cost-frames frames each: the render
             loop's device ms a frame (CUDA events) and host ms a render
             call, the present loop's host ms a frame; and the host ns of
             the spans of one present-loop frame, alone
  window     --seconds of each loop, render then present, on the traced
             Renderer, the frame records read without a synchronize every
             512 frames: per block of 512 frames the frame's pace, each marked
             interval, the gap between frames, the queue latency (a frame
             span's end to the frame's first mark) and the host-bound time
             (max(0, next frame span's end - the frame's last mark)); in the
             present loop the present.wait and present.copy spans too

Set TPURAST_TORCH_SCENE_CACHE=0 on a machine that is thrown away.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from tpurast_torch import tracing
from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene_cache import load_named_scene
from tpurast_torch.present import Presenter
from tpurast_torch.renderer import Renderer

BLOCK = 512
#: Each mark, the profiler's event that stands at the same point: (kernel
#: names, "start" or "end"). Marks 0, 1 and 6 are the mark kernels, in
#: frame order; the others the render kernels that stamp them.
MARK_EVENTS = (
    (("mark_kernel",), "start"),
    (("mark_kernel",), "start"),
    (("raster_units_kernel",), "start"),
    (("raster_unpack_kernel",), "end"),
    (("resolve_kernel", "shade_deferred_kernel"), "start"),
    (("sample_kernel", "shade_gbuffer_kernel", "shade_deferred_kernel"), "end"),
    (("mark_kernel",), "start"),
)
NODES = tuple(i for i in range(len(tracing.MARKS)) if i not in tracing.STAMPED)


def cameras(radius: float, n: int = 628) -> list[Camera]:
    return [Camera.from_target(np.array([radius * math.sin(0.01 * k), 0.0, -radius * math.cos(0.01 * k)],
                                        np.float32), [0.0, 0.0, 0.0]) for k in range(n)]


def _device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start us, length us) of every kernel, copy and set in a profile, in order."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                  key=lambda e: e[1])


def _mark_events(prof) -> list[tuple[float, float]]:
    """(start us, length us) of every mark kernel in a profile, in order."""
    return [(s, d) for n, s, d in _device_events(prof) if "mark_kernel" in n]


def device_ops(r: Renderer, cams, n: int = 32) -> dict:
    """Device operations a frame of the Renderer's graph, and their names."""
    torch.cuda.synchronize(r.device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for k in range(n):
            r.render(cams[k])
        torch.cuda.synchronize(r.device)
    events = _device_events(prof)
    return {"per_frame": len(events) / n, "names": sorted({name for name, _, _ in events})}


def _nearest(ref: np.ndarray, x: np.ndarray) -> np.ndarray:
    j = np.clip(np.searchsorted(ref, x), 1, len(ref) - 1)
    return np.where(np.abs(ref[j] - x) < np.abs(ref[j - 1] - x), j, j - 1)


def _pair(mapped_us: np.ndarray, starts: np.ndarray, per_frame: int = len(NODES)) -> np.ndarray:
    """For each mapped mark kernel (per_frame a frame), the index of the
    profiler's mark kernel start nearest to it once the two clocks' offset
    and rate are fitted (the profiler may drop events): the offset that
    takes one of the first frame's marks to the first event and pairs the
    most of the first ten frames' marks within 20 us (a frame later would
    pair as many: the first frame holds the first event), then a rate and
    offset fitted on those pairs."""

    def nearest(x):
        return _nearest(starts, x)

    head = mapped_us[:10 * per_frame]
    offsets = starts[0] - head[:per_frame]
    best = offsets[int(np.argmax([(np.abs(starts[nearest(head + o)] - head - o) < 20).sum() for o in offsets]))]
    j = nearest(mapped_us + best)
    ok = np.abs(starts[j] - mapped_us - best) < 20
    fit = np.polyfit(mapped_us[ok], starts[j[ok]], 1)
    return nearest(np.polyval(fit, mapped_us))


def agreement(r: Renderer, cams, frames: int) -> dict:
    device = r.device
    torch.cuda.synchronize(device)
    first = r.marks.enqueued + 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for k in range(frames):
            r.render(cams[k % len(cams)])
        torch.cuda.synchronize(device)
    events = _device_events(prof)
    snap = tracing.snapshot()
    rec = snap.frames[str(r.marks.device)]
    keep = (rec["seq"] >= first) & (rec["seq"] < first + frames)
    t = rec["t_ns"][keep] / 1e3  # (frames, 7) us on the host's clock
    nodes = t[:, list(NODES)].reshape(-1)
    node_events = [(s, d) for n, s, d in events if "mark_kernel" in n]
    starts = np.array([s for s, _ in node_events])
    j = _pair(nodes, starts)
    offset = float(np.median(starts[j] - nodes))
    rate_fit = np.polyfit(nodes, starts[j], 1)
    raw, fitted = np.full(t.shape, np.nan), np.full(t.shape, np.nan)
    for i, (names, edge) in enumerate(MARK_EVENTS):
        ref = np.sort([s + (d if edge == "end" else 0.0) for n, s, d in events if any(k in n for k in names)])
        if len(ref) < 2:
            continue
        for out, x in ((raw, t[:, i] + offset), (fitted, np.polyval(rate_fit, t[:, i]))):
            out[:, i] = x - ref[_nearest(ref, x)]

    def spread(d):
        d = d - np.nanmedian(d)
        ok = np.abs(d) < 10  # a mark whose event the profiler dropped pairs with a neighbour's, far off
        return ok, d[ok]

    ok, d_raw = spread(raw)
    _, d_fit = spread(fitted)
    cal = snap.calibrations[str(r.marks.device)]
    off = cal[:, 1] - cal[:, 0]
    return {
        "frames": int(keep.sum()), "marks": int(t.size), "profiled_mark_kernels": len(starts),
        "paired": int(ok.sum()),
        "diff_us_p5_p50_p95": [float(x) for x in np.percentile(d_raw, [5, 50, 95])],
        "diff_spread_us": float(np.percentile(d_raw, 95) - np.percentile(d_raw, 5)),
        "by_mark_median_us": [float(np.nanmedian(raw[:, i] - np.nanmedian(raw))) for i in range(t.shape[1])],
        "profiler_rate_ppm": float(rate_fit[0] - 1.0) * 1e6,
        "fitted_spread_us": float(np.percentile(d_fit, 95) - np.percentile(d_fit, 5)),
        "marks_device_us_per_frame": sum(d for _, d in node_events) / frames,
        "calibrations": len(cal),
        "round_trip_us": [float(x) / 1e3 for x in cal[:, 2]],
        "drift_us": float(off[-1] - off[0]) / 1e3,
        "drift_ppm": float(off[-1] - off[0]) / max(float(cal[-1, 1] - cal[0, 1]), 1.0) * 1e6,
        "calibrations_apart_s": float(cal[-1, 1] - cal[0, 1]) / 1e9,
    }


def _render_loop(r: Renderer, cams, n: int) -> tuple[float, float]:
    """(device ms a frame by CUDA events, host ms a render call)."""
    torch.cuda.synchronize(r.device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    host = 0.0
    for k in range(n):
        u = r.frame_uniforms(cams[k % len(cams)])
        h0 = time.perf_counter()
        r.render_with_uniforms(*u)
        host += time.perf_counter() - h0
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n, host / n * 1e3


def _present_loop(r: Renderer, p: Presenter, cams, n: int) -> float:
    """Host ms a frame handed out."""
    torch.cuda.synchronize(r.device)
    t0 = time.perf_counter()
    for k in range(n):
        p.present(r.render(cams[k % len(cams)])["color"])
    p.flush()
    return (time.perf_counter() - t0) / n * 1e3


def present_spans_ns(n: int = 100_000) -> float:
    """Host ns of the spans of one present-loop frame: ``frame``, then
    ``present.wait`` followed by ``present.copy``, as the loop records them."""
    frame, wait, copy = tracing.FRAME, tracing.PRESENT_WAIT, tracing.PRESENT_COPY
    t0 = time.perf_counter_ns()
    for _ in range(n):
        frame.end(frame.begin())
        copy.end(wait.then(wait.begin(), copy))
    return (time.perf_counter_ns() - t0) / n


def cost(on: Renderer, off: Renderer, cams, frames: int, rounds: int) -> dict:
    """--rounds pairs in each order (on, off) and (off, on), alternating;
    the on-cost of each pair, and their medians."""
    runs = {"on": [], "off": []}
    p = Presenter()
    for i in range(2 * rounds):
        for name in (("on", "off") if i % 2 == 0 else ("off", "on")):
            r = on if name == "on" else off
            dev_ms, host_ms = _render_loop(r, cams, frames)
            runs[name].append({"render_device_ms": dev_ms, "render_host_ms": host_ms,
                               "present_host_ms": _present_loop(r, p, cams, frames)})
    keys = list(runs["on"][0])
    pairs = {k: [a[k] - b[k] for a, b in zip(runs["on"], runs["off"])] for k in keys}
    return {"median": {name: {k: float(np.median([x[k] for x in v])) for k in keys} for name, v in runs.items()},
            "on_less_off_us": {k: [float(x) * 1e3 for x in v] for k, v in pairs.items()},
            "on_less_off_median_us": {k: float(np.median(v)) * 1e3 for k, v in pairs.items()},
            "runs": runs, "present_spans_ns": present_spans_ns()}


def window(r: Renderer, cams, seconds: float, present: Presenter | None) -> dict:
    """--seconds of the loop, records polled every BLOCK frames (module docstring)."""
    marks = r.marks
    raw: dict[int, np.ndarray] = {}

    def poll():
        rows = np.array(marks.records[: marks.slots])
        for row in rows[(rows[:, 0] > 0) & (rows[:, tracing.DONE] == rows[:, 0])]:
            raw.setdefault(int(row[0]), row)

    torch.cuda.synchronize(r.device)
    first = marks.enqueued + 1
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        out = r.render(cams[k % len(cams)])
        if present is not None:
            present.present(out["color"])
        k += 1
        if k % BLOCK == 0:
            poll()
    if present is not None:
        present.flush()
    torch.cuda.synchronize(r.device)
    poll()
    snap = tracing.snapshot()
    seqs = np.arange(first, first + k)
    got = np.array([s in raw for s in seqs])
    rows = np.stack([raw[s] for s in seqs[got]])
    t = tracing.to_host_clock(rows[:, 1:1 + len(tracing.MARKS)], marks.calibrations)
    spans = snap.spans
    in_window = (spans["frame"] >= first) & (spans["frame"] < first + k)

    def by_frame(name):
        sel = in_window & (spans["name"] == name)
        out = np.full(k, np.nan)
        out[spans["frame"][sel] - first] = (spans["end_ns"][sel] - spans["start_ns"][sel]) / 1e6
        return out, sel

    frame_end = np.full(k, np.nan)
    sel = in_window & (spans["name"] == "frame")
    frame_end[spans["frame"][sel] - first] = spans["end_ns"][sel]
    frame_end = frame_end[got]
    steps = np.diff(t, axis=1) / 1e6
    cols = {name: steps[:, i] for i, name in enumerate(tracing.MARKS[1:])}
    nxt = np.append(t[1:, 0], np.nan)
    cols["pace"] = (nxt - t[:, 0]) / 1e6
    cols["between_frames"] = (nxt - t[:, -1]) / 1e6
    cols["queue_latency"] = (t[:, 0] - frame_end) / 1e6
    cols["host_bound"] = np.maximum(0.0, np.append(frame_end[1:], np.nan) - t[:, -1]) / 1e6
    if present is not None:
        for name in ("present.wait", "present.copy"):
            cols[name] = by_frame(name)[0][got]
    blocks = {name: [float(np.nanmean(v[i:i + BLOCK])) for i in range(0, len(v), BLOCK)] for name, v in cols.items()}
    return {"frames": k, "records": int(got.sum()), "seconds": seconds,
            "mean": {name: float(np.nanmean(v)) for name, v in cols.items()},
            "quarters": {name: [float(np.nanmean(q)) for q in np.array_split(v, 4)] for name, v in cols.items()},
            "blocks": blocks}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="orbit", choices=("orbit", "porsche_class"))
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--textures", type=int, default=12, help="porsche_class: textures bound")
    ap.add_argument("--shading", default="forward", choices=("forward", "deferred"))
    ap.add_argument("--radius", type=float, default=2.5)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--cost-frames", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=3, help="cost: pairs in each order")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_check: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    if args.scene == "orbit":
        scene = load_named_scene("orbit")
    else:
        scene = load_named_scene("porsche_class", args.data_dir, max_textures=args.textures)
    cfg = RendererConfig(width=1920, height=1080, shading=args.shading)
    on = Renderer(scene, cfg, device=device)
    off = Renderer(scene, cfg, device=device, trace=False)
    cams = cameras(args.radius)
    for r in (on, off):
        for c in cams[:16]:
            r.render(c)
    torch.cuda.synchronize(device)
    same = all(torch.equal(a, b) for a, b in zip(on.render(cams[3]).values(), off.render(cams[3]).values()))
    ops = {"on": device_ops(on, cams), "off": device_ops(off, cams)}
    marks_only = sorted(set(ops["on"]["names"]) - set(ops["off"]["names"]))
    results = {"device": torch.cuda.get_device_name(device), "scene": args.scene, "shading": args.shading,
               "same_frame": same, "ops_per_frame": {k: v["per_frame"] for k, v in ops.items()},
               "only_traced": marks_only, "only_untraced": sorted(set(ops["off"]["names"]) - set(ops["on"]["names"]))}
    phases = [
        ("agreement", lambda: agreement(on, cams, args.frames)),
        ("cost", lambda: cost(on, off, cams, args.cost_frames, args.rounds)),
        ("window", lambda: window(on, cams, args.seconds, None)),
        ("window_present", lambda: window(on, cams, args.seconds, Presenter())),
    ]
    print(json.dumps({k: results[k] for k in results}), flush=True)
    for name, fn in phases:
        t0 = time.perf_counter()
        results[name] = fn()
        line = {"phase": name, "s": round(time.perf_counter() - t0, 3),
                **{k: v for k, v in results[name].items() if k not in ("blocks", "runs")}}
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
