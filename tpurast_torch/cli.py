"""The port's benchmark entry point (counterpart of tpurast/cli.py).

    python -m tpurast_torch.cli --scene orbit [--width 1920 --height 1080]

Prints ONE JSON line with fps / p50 / Mtris plus the present-loop
(host-visible) frame rate, the dropped-pair counter, the parity gate's
result and the binning that ran ("pairs" or "scan"). `--stages` adds a
per-stage decomposition to the line: stage_ms, the mean ms of each stage
over the timed frames, from the frames' own stage marks (tracing.py; on
the card the device's clock, in the graph the frames replay); `--all`
runs every config of ALL_CONFIGS in a subprocess of its own and prints
one line each.

It runs on the card: without a CUDA device it exits non-zero unless
`--device cpu` asks for the CPU (the kernels' plain torch versions; its
times are the host's and say nothing about the card). Every scene but
"orbit" (procedural, from `--seed`) reads the reference's data directory
(meshes/, textures/), which `--data-dir` names; a missing one exits
non-zero.

Frame time: after `--warmup` frames, `--frames` frames run in groups of 16
between two CUDA events with one synchronize per group; p50_frame_ms is the
median over frames of their group's per-frame time. bin_overflow and
window_miss_px are read once per group, from its last frame. The present
loop renders 48 more frames through present.Presenter (double-buffered
read-back into pinned memory) on the host's clock.

The parity gate renders one 256x128 frame with the CUDA kernels and again
with every kernel's plain torch version on the same device
(kernels.plain_kernels); above 1 LSB it prints the failure in place of any
time and exits 1. On the card its kernel frame is a replay of the gate
Renderer's CUDA graph (the first frame captures it), and the plain frame
runs eagerly.

On the card every frame the bench times is a replay of the Renderer's CUDA
graph (graphs.FrameGraph): the first warm-up frame captures it, and the
line's capture_ms and graph_pool_bytes say what that took (the reference's
bench counts its compile in the warm-up too); both are null on the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

from tpurast_torch.device.scene_cache import SCENES

#: Benchmark configs for --all: (extra argv, config label). The first is
#: procedural; the others are BASELINE.md's and read the data directory.
ALL_CONFIGS = [
    (["--scene", "orbit", "--width", "1920", "--height", "1080"], "orbit_1080p"),
    (["--scene", "demo", "--width", "1920", "--height", "1080"], "demo_1080p"),
    (
        ["--scene", "porsche_class", "--width", "1920", "--height", "1080"],
        "porsche_class_1080p",
    ),
    (["--scene", "hdr", "--width", "1920", "--height", "1080"], "hdr_1080p"),
    (
        ["--scene", "dragons64", "--width", "3840", "--height", "2160"],
        "dragons64_4k",
    ),
]

GROUP = 16  # frames between two timing events
PRESENT_FRAMES = 48


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--data-dir", default=None, help="the reference's data directory (meshes/, textures/)")
    ap.add_argument("--texture-dtype", default=None)
    ap.add_argument("--tile-h", type=int, default=None)
    ap.add_argument("--tile-w", type=int, default=None)
    ap.add_argument("--max-anisotropy", type=int, default=None)
    ap.add_argument("--vsync", action="store_true", help="cap the present loop at 60 Hz (Engine.vsync analog)")
    ap.add_argument("--shading", default=None, choices=["forward", "deferred"])
    ap.add_argument("--binning", default=None, choices=["auto", "pairs", "scan"])
    ap.add_argument("--sampler", default=None, choices=["auto", "window", "gather"])
    ap.add_argument(
        "--scene",
        default="demo",
        choices=list(SCENES),
        help="demo = the reference's Engine.init scene; dragons64 = BASELINE config #4; orbit = the "
        "procedural scene (no data directory)",
    )
    ap.add_argument("--device", default="cuda", help='"cuda" (default), "cuda:N" or "cpu"')
    ap.add_argument("--seed", type=int, default=0, help="seed of the procedural scene (orbit)")
    ap.add_argument("--save", default=None, help="save last frame PNG here")
    ap.add_argument("--skip-parity-gate", action="store_true", help="skip the kernels-vs-plain-versions check")
    ap.add_argument("--stages", action="store_true",
                    help="add per-stage timing (stage_ms, from the timed frames' stage marks) to the JSON line")
    ap.add_argument("--all", action="store_true", help="run every config of ALL_CONFIGS (one JSON line each)")
    return ap


def _run_all(argv_rest: list[str]) -> int:
    """Run each config in its own subprocess (fresh device memory per
    scene) and forward the JSON lines."""
    rc_all = 0
    for extra, label in ALL_CONFIGS:
        cmd = [sys.executable, "-m", "tpurast_torch.cli", *extra, *argv_rest]
        print(f"# config {label}: {' '.join(cmd[2:])}", file=sys.stderr)
        rc = subprocess.call(cmd)
        rc_all = rc_all or rc
    return rc_all


def _without_scene_and_size(argv: list[str]) -> list[str]:
    """argv without --all and without the options --all sets itself."""
    out, drop_next = [], False
    for a in argv:
        if drop_next:
            drop_next = False
        elif a in ("--scene", "--width", "--height"):
            drop_next = True
        elif a != "--all" and not a.startswith(("--scene=", "--width=", "--height=")):
            out.append(a)
    return out


def flythrough(scene_name: str, n: int) -> list:
    """n cameras of a slow orbit (0.01 rad a frame): around the procedural
    scene on its track, else near the demo scene's crate and dragon like
    the reference's screenshots."""
    from tpurast_torch.camera import Camera
    from tpurast_torch.device.scene import orbit_track

    if scene_name == "orbit":
        return orbit_track(max(n, 628))[:n]
    cams = []
    for i in range(n):
        ang = 0.4 + 0.01 * i
        pos = np.array([1.2 * np.sin(ang), 0.75, -1.2 * np.cos(ang)], dtype=np.float32)
        cams.append(Camera.from_target(pos, [0.0, 0.95, 0.0]))
    return cams


def power_limit_w(index: int) -> float | None:
    """The card's power limit as nvidia-smi reports it, None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.CalledProcessError, ValueError, IndexError):
        return None


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _build_parser().parse_args(argv)
    if args.all:
        return _run_all(_without_scene_and_size(argv))

    import torch

    from tpurast_torch import kernels, tracing
    from tpurast_torch.config import RendererConfig
    from tpurast_torch.device.scene_cache import load_named_scene
    from tpurast_torch.present import Presenter
    from tpurast_torch.profiling import time_groups
    from tpurast_torch.renderer import Renderer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("tpurast_torch.cli: no CUDA device (torch.cuda.is_available() is false); the bench times the "
              "card. Pass --device cpu to run the plain torch versions on the host.", file=sys.stderr)
        return 2
    on_card = device.type == "cuda"

    try:
        if args.scene == "orbit":
            scene = load_named_scene("orbit", seed=args.seed)
        else:
            scene = load_named_scene(args.scene, args.data_dir)
    except FileNotFoundError as e:
        print(f"tpurast_torch.cli: {e} (pass --data-dir, or --scene orbit for the procedural scene)",
              file=sys.stderr)
        return 2
    overrides = {}
    if args.texture_dtype:
        overrides["texture_dtype"] = args.texture_dtype
    if args.tile_h:
        overrides["tile_h"] = args.tile_h
    if args.tile_w:
        overrides["tile_w"] = args.tile_w
    if args.max_anisotropy is not None:
        overrides["max_anisotropy"] = args.max_anisotropy
    if args.shading:
        overrides["shading"] = args.shading
    if args.binning:
        overrides["binning"] = args.binning
    if args.sampler:
        overrides["sampler"] = args.sampler
    cfg = RendererConfig(width=args.width, height=args.height, **overrides)
    renderer = Renderer(scene, cfg, device=device)

    cams = flythrough(args.scene, args.frames + args.warmup)

    # Correctness gate: one small frame with the CUDA kernels and once more
    # with every kernel's plain torch version on the SAME device; any
    # >1-LSB value means a kernel-only fault that the CPU tests cannot see.
    # The bench REFUSES to print a perf number on failure. (On the CPU both
    # sides are the plain versions.)
    parity_max_lsb = None
    if not args.skip_parity_gate:
        gate = Renderer(scene, RendererConfig(width=256, height=128, **overrides), device=device)
        if gate.uses_graphs:
            gate.render(cams[0])  # captures the graph; the frame below replays it
        fa = gate.render_to_host(cams[0]).astype(np.int32)
        with kernels.plain_kernels():
            fb = gate.render_to_host(cams[0]).astype(np.int32)
        del gate
        parity_max_lsb = int(np.abs(fa - fb).max())
        if parity_max_lsb > 1:
            print(json.dumps({
                "metric": "parity_gate_failed",
                "value": parity_max_lsb,
                "unit": "max_lsb_diff",
                "bad_channels": int((np.abs(fa - fb) > 1).sum()),
            }))
            return 1

    # Precomputed uniforms, so the loops measure only render + read-back.
    uniforms = [renderer.frame_uniforms(c) for c in cams]

    def render(_scene, view_proj, camera_position):
        return renderer.render_with_uniforms(view_proj, camera_position)

    for u in uniforms[: args.warmup]:
        render(None, *u)
    if on_card:
        torch.cuda.synchronize(device)

    counters = {"dropped": 0, "window_miss": 0}

    def read_counters(frame):
        # Honest-overflow accounting: an overflowing binner would silently
        # drop triangles AND flatter the benchmark. Read once per group,
        # after its synchronize, outside the timed span.
        counters["dropped"] += int(frame["bin_overflow"])
        counters["window_miss"] += int(frame["window_miss_px"])

    batch = uniforms[args.warmup : args.warmup + args.frames]
    first_seq = renderer.marks.enqueued + 1
    t0 = time.perf_counter()
    group_ms = time_groups(render, renderer.scene, batch, GROUP, after_group=read_counters)
    wall = time.perf_counter() - t0
    timed_seqs = (first_seq, renderer.marks.enqueued)
    times_ms = np.repeat(group_ms, [len(batch[g : g + GROUP]) for g in range(0, len(batch), GROUP)])

    # The flythrough with device->host read-back: the timed loop includes
    # the double-buffered full-frame read-back, so present_fps is the
    # host-visible frame rate.
    presenter = Presenter()
    last_host = None
    n_present = min(len(batch), PRESENT_FRAMES)
    tp0 = time.perf_counter()
    for u in batch[:n_present]:
        t_frame = time.perf_counter()
        img = presenter.present(render(None, *u)["color"])
        if args.vsync:  # Engine.vsync analog: 60 Hz frame cap
            time.sleep(max(0.0, 1.0 / 60.0 - (time.perf_counter() - t_frame)))
        if img is not None:
            last_host = img
    tail = presenter.flush()
    present_ms = (time.perf_counter() - tp0) / max(n_present, 1) * 1e3
    if tail is not None:
        last_host = tail

    stage_ms = None
    if args.stages:
        frames = tracing.snapshot().frames[str(renderer.marks.device)]
        stage_ms = {k: round(v, 4) for k, v in tracing.stage_ms(frames, *timed_seqs).items()}

    graph = renderer.graph_info().get("frame", {})
    p50 = float(np.percentile(times_ms, 50))
    fps = 1000.0 / p50

    if args.save and last_host is not None:
        from PIL import Image

        Image.fromarray(last_host[..., :3]).save(args.save)

    result = {
        "metric": f"fps_{args.width}x{args.height}_{args.scene}_scene",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "p50_frame_ms": round(p50, 4),
        "mean_frame_ms": round(float(times_ms.mean()), 4),
        "mtris_per_sec": round(scene.n_faces * fps / 1e6, 2),
        "triangles": scene.n_faces,
        "binning": renderer.binning,
        "frames": args.frames,
        "wall_s": round(wall, 2),
        "dropped_pairs": counters["dropped"],
        "window_miss_px": counters["window_miss"],
        "parity_max_lsb": parity_max_lsb,
        "stage_ms": stage_ms,
        "present_ms_per_frame": round(present_ms, 4),
        "present_fps": round(1000.0 / present_ms, 2) if present_ms > 0 else None,
        "capture_ms": round(graph["capture_ms"], 3) if graph else None,
        "graph_pool_bytes": graph.get("pool_bytes"),
        "backend": "cuda" if on_card else "cpu",
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "power_limit_w": power_limit_w(device.index or 0) if on_card else None,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
