"""Sampler-iteration probe: p50 cumulative ms of chosen render_frame
prefixes only.

Counterpart of tools/sample_stage_probe.py: for each name of --stages
(default "plan,sample"; "frame" is the whole frame) it times that prefix
with profiling.time_grouped and prints {name: ms} as it goes, then one
line {"cum_ms": {...}}. Where the reference jits each prefix, each is a
CUDA graph on the card (graphs.FrameGraph); on the CPU and inside
kernels.plain_kernels() the prefixes run eagerly.

Run: python -m tpurast_torch.tools.sample_stage_probe [--scene orbit] [--stages plan,sample,frame]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

from tpurast_torch.cli import flythrough
from tpurast_torch.config import RendererConfig
from tpurast_torch.graphs import FrameGraph, graph_wanted
from tpurast_torch.profiling import time_grouped
from tpurast_torch.renderer import Renderer, render_frame
from tpurast_torch.tools import _common


def probe(scene, *, scene_name: str = "orbit", width: int = 1920, height: int = 1080, frames: int = 32,
          stages=("plan", "sample"), device="cuda", warmup: int = 4, emit=None) -> dict:
    """{stage: p50 cumulative ms}; emit(stage, ms) is called after each."""
    r = Renderer(scene, RendererConfig(width=width, height=height), device=device)
    uniforms = [r.frame_uniforms(c) for c in flythrough(scene_name, max(64, warmup + frames))]
    out = {}
    for s in stages:
        fn = functools.partial(render_frame, **r._frame_kwargs, stage=None if s == "frame" else s)
        if graph_wanted(r.device):
            fn = FrameGraph(fn, name=f"stage {s}")
        try:
            out[s] = round(time_grouped(fn, r.scene, uniforms, warmup=warmup, frames=frames), 3)
        finally:
            if isinstance(fn, FrameGraph):
                fn.close()
        if emit is not None:
            emit(s, out[s])
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--stages", default="plan,sample", help="comma-separated stage names ('frame' = full)")
    _common.add_scene_args(ap)
    args = ap.parse_args(argv)
    opened = _common.open_scene("sample_stage_probe", args)
    if opened is None:
        return 2
    scene, device = opened
    out = probe(scene, scene_name=args.scene, width=args.width, height=args.height, frames=args.frames,
                stages=args.stages.split(","), device=device,
                emit=lambda s, ms: print(json.dumps({s: ms}), flush=True))
    print(json.dumps({"cum_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
