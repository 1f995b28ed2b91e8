"""Per-stage timing of the production frame path.

Counterpart of tools/profile_stages.py: a thin command line over
profiling.stage_sweep, which times prefixes of render_frame (its stage=
parameter) one after another, so the differences between successive
prefixes are the per-stage costs on the production path. Prints one JSON
line {"cum_ms": ..., "stage_ms": ...}.

Run: python -m tpurast_torch.tools.profile_stages [--scene orbit] [--width 1920] ...
"""

from __future__ import annotations

import argparse
import json
import sys

from tpurast_torch.cli import flythrough
from tpurast_torch.config import RendererConfig
from tpurast_torch.profiling import stage_sweep
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import _common


def profile(scene, *, scene_name: str = "orbit", width: int = 1920, height: int = 1080, frames: int = 24,
            max_anisotropy: int | None = None, sampler: str | None = None, device="cuda",
            warmup: int = 4) -> dict:
    """{"cum_ms", "stage_ms"} of stage_sweep over the scene's flythrough."""
    overrides = {}
    if max_anisotropy is not None:
        overrides["max_anisotropy"] = max_anisotropy
    if sampler:
        overrides["sampler"] = sampler
    r = Renderer(scene, RendererConfig(width=width, height=height, **overrides), device=device)
    uniforms = [r.frame_uniforms(c) for c in flythrough(scene_name, max(64, warmup + frames))]
    cum, delta = stage_sweep(r, uniforms, frames=frames, warmup=warmup)
    return {"cum_ms": cum, "stage_ms": delta}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--max-anisotropy", type=int, default=None)
    ap.add_argument("--sampler", default=None)
    _common.add_scene_args(ap)
    args = ap.parse_args(argv)
    opened = _common.open_scene("profile_stages", args)
    if opened is None:
        return 2
    scene, device = opened
    out = profile(scene, scene_name=args.scene, width=args.width, height=args.height, frames=args.frames,
                  max_anisotropy=args.max_anisotropy, sampler=args.sampler, device=device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
