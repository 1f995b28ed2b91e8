"""Run one cell of the benchmark of tpurast_torch once, and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of BENCHMARK.json at the checkout's root:
a configuration (portbench/configs/<config>.json: the scene recipe, the
render target, RendererConfig fields) under a traffic mix
(portbench/traffic/<mix>.json: the camera track and its poses, the loop,
the traffic's own RendererConfig fields, the comparison's limits). A run

  1. makes the scene's inputs from the seed and builds the program's scene,
     Renderer, cameras (and Presenter) from them, then warms up the one
     frame shape the cell renders: set-up, reported as setup_s;
  2. runs the loop for --seconds (portbench/loops.py), no synchronize
     inside, and takes the end-to-end metrics (--trace 0);
  3. with --trace 1, runs a slice of the loop under torch.profiler
     (portbench/trace.py) and takes the per-layer metrics from it;
  4. frees the program's state and renders the sampled frames' poses with
     the plain reference (portbench/reference/), which decides ``correct``
     (portbench/check.py) together with every frame's count of dropped
     pairs, and with --trace 1 the work that the roofline shares divide
     (portbench/yardstick.py);
  5. prints the numbers it compared, each beside its limit, as its last
     lines on standard error, and one JSON line as the last line of
     standard output.

Every metric is read by a file of its own, portbench/metrics/<name>.py,
found by its name in BENCHMARK.json. Without a CUDA device, with fewer
cards than the cell asks for, or with jax, flax or the JAX package loaded
once the window has closed, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up is counted from the process's first line

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpurast")
#: Frames of the cell's pose track rendered before the window, as set-up.
WARMUP_FRAMES = 16
#: Frames of the window kept for the comparison with the reference.
COMPARE_FRAMES = 8
#: Frames of the traced slice (--trace 1), and the reference's frames of it
#: whose work counts divide the roofline shares.
TRACE_FRAMES = 256
BOUND_FRAMES = 4


@dataclasses.dataclass
class Run:
    """What a metric reader (portbench/metrics/<name>.py) reads."""

    setup_s: float
    window: object  # loops.Window of the timed loop
    reading: object | None  # trace.Reading of the traced slice (--trace 1)


def load_json(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())


def cell_files(manifest: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic file) of a cell, by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    config_entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return cell, load_json(ROOT / config_entry["file"]), load_json(BENCH / "traffic" / f"{cell['traffic']}.json")


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (--trace 0) or per-layer metrics (--trace 1)."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """portbench/metrics/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(config: dict, traffic: dict, metrics: list[dict], seed: int, seconds: float, trace: bool,
             device: str = "cuda", warmup_frames: int = WARMUP_FRAMES, compare_frames: int = COMPARE_FRAMES,
             trace_frames: int = TRACE_FRAMES, bound_frames: int = BOUND_FRAMES) -> dict:
    """One run of a configuration under a traffic mix on ``device``; returns
    the result line's fields (and ``compared``, the numbers and limits)."""
    import numpy as np
    import torch

    from portbench import check, loops, scenes, system, yardstick
    from portbench import trace as tracing
    from portbench.reference import render as rrender
    from portbench.scenes import tracks

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    fields = {**config.get("renderer", {}), **traffic.get("renderer", {})}
    width, height = config["width"], config["height"]

    inputs = scenes.scene_inputs(config["scene"], seed, CACHE)
    renderer = system.renderer(system.program_scene(inputs), width, height, fields, dev)
    poses = tracks.circle_track(traffic["track"], traffic["poses"])
    cams = system.cameras(poses)
    start = tracks.start_pose(seed, len(poses))
    present = traffic["loop"] == "present"
    presenter = system.presenter() if present else None
    loops.warm_up(renderer, cams, start, warmup_frames, presenter)
    setup_s = time.perf_counter() - _T0

    def loop(begin, reservoir, span=loops.no_span, secs=seconds, frames=None):
        if present:
            return loops.present_window(renderer, presenter, cams, begin, secs, reservoir, span, frames)
        return loops.render_window(renderer, cams, begin, secs, reservoir, span, frames)

    window = loop(start, loops.Reservoir(compare_frames, seed))
    failed = int(torch.stack([o.reshape(()) for o in window.overflow]).ne(0).sum())
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    events = spans = None
    slice_start = (start + window.frames) % len(poses)
    if trace:
        def run_slice(span):
            w = loop(slice_start, loops.Reservoir(0, seed), span, float("inf"), trace_frames)
            with span("counter_read"):
                int(torch.stack([o.reshape(()) for o in w.overflow]).ne(0).sum())

        CACHE.mkdir(parents=True, exist_ok=True)
        events, spans = tracing.profile(run_slice, str(CACHE / "trace.json"), dev)

    sample = [(pose, check.as_planes(frame)) for pose, frame in window.sample]
    window.sample.clear()
    window.overflow.clear()
    del renderer, presenter, cams
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    target = rrender.target_of(config, fields)
    m = bound_frames if trace else 0
    stats_poses = [poses[(slice_start + round(i * (trace_frames - 1) / max(m - 1, 1))) % len(poses)]
                   for i in range(m)]
    want, stats = check.reference_frames(inputs, fields, target, [poses[p] for p, _ in sample], dev,
                                         stats_poses=stats_poses)
    numbers = {**check.compare([f for _, f in sample], want), "dropped_pair_frames": float(failed)}
    limits = {**traffic["limits"], **check.GUARANTEES}

    reading = None
    if trace and events:
        # The window sampler's frames divide the sample kernel's time, the
        # row atlas' frames the deferred kernel's.
        kernels = ("raster", "sample" if stats[0]["row_format"] == "page" else "deferred")
        bounds = {k: float(np.mean([yardstick.BOUNDS[k](s) for s in stats])) for k in kernels}
        layers = load_json(BENCH / "kernels.json")["layers"]
        reading = tracing.read(events, spans, trace_frames, layers, traffic["loop"], bounds)
    run = Run(setup_s=setup_s, window=window, reading=reading)
    values = {}
    for metric in metrics:
        mod = reader(metric["name"])
        v = mod.read(run)
        if v is not None:
            values[metric["name"]] = {"value": float(v), "unit": metric["unit"]}
    result = {
        "correct": check.judge(numbers, limits),
        "attempted": window.frames,
        "failed": failed,
        "metrics": values,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if reading is not None:
        result["device"].update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = {"device_ops": [[n[:120], s] for n, s in reading.device_ops],
                               "idle_gaps": reading.idle_gaps}
    result["intervals_ms"] = window.intervals_ms
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


def loaded_forbidden() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = cell_files(manifest, args.workload)

    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(config, traffic, cell_metrics(manifest, args.workload, bool(args.trace)), args.seed,
                      args.seconds, bool(args.trace))
    result["power_limit_w"] = power_limit_w()
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: modules of {bad} are loaded in the process that would print the result", file=sys.stderr)
        return 3
    iv = result.pop("intervals_ms")
    print("intervals ms p50 %.4f p90 %.4f p95 %.4f p99 %.4f max %.4f (frame %d) over %d frames" % (
        *np.percentile(iv, [50, 90, 95, 99]), iv.max(), int(iv.argmax()), len(iv)), file=sys.stderr)
    print("intervals ms mean by quarter of the window " + " ".join("%.4f" % q.mean() for q in np.array_split(iv, 4)),
          file=sys.stderr)
    compared = result.pop("compared")
    result["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
