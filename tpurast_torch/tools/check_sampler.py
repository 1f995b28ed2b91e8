"""A/B check: the window sampler against the row-atlas gather.

Counterpart of tools/check_sampler.py: renders --frames cameras with both
samplers and prints, per frame, the largest u8 difference, the window
path's residual pixel count and both frames' host times; then the worst
difference against the 1-LSB budget (bf16 page texels and f16 / f32 atlas
rows round differently). Exits 1 over budget.

Run: python -m tpurast_torch.tools.check_sampler [--scene orbit] [--width 256] [--height 128] [--aniso N]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import _common

BUDGET_LSB = 1


def cameras(scene_name: str, frames: int) -> list:
    """The reference's cameras over angles 0.2-1.1 rad (on the orbit scene,
    orbit_track's cameras at those angles)."""
    angles = np.linspace(0.2, 1.1, frames)
    if scene_name == "orbit":
        return [_common.camera_at("orbit", float(a)) for a in angles]
    return [Camera.from_target(np.array([1.4 * np.sin(a), 0.8 + 0.1 * np.sin(2 * a), -1.4 * np.cos(a)], np.float32),
                               [0.0, 0.9, 0.0]) for a in angles]


def check(scene, *, scene_name: str = "orbit", width: int = 256, height: int = 128, aniso: int = 1,
          frames: int = 4, device="cuda") -> tuple[list[str], int]:
    """(the reference's printed lines, the worst difference in LSB)."""
    renderers = {
        samp: Renderer(scene, RendererConfig(width=width, height=height, sampler=samp, max_anisotropy=aniso,
                                             segment_headroom=256), device=device)
        for samp in ("window", "gather")
    }
    lines, worst = [], 0
    for which, cam in enumerate(cameras(scene_name, frames)):
        out = {}
        for samp, r in renderers.items():
            t0 = time.perf_counter()
            res = r.render(cam)
            frame = res["color"].cpu().numpy()
            out[samp] = (frame, int(res["window_miss_px"]), time.perf_counter() - t0)
        dmax = int(np.abs(out["window"][0].astype(np.int32) - out["gather"][0].astype(np.int32)).max())
        worst = max(worst, dmax)
        lines.append(f"frame {which}: max_lsb={dmax} window_miss_px={out['window'][1]}"
                     f" (window {out['window'][2] * 1e3:.0f} ms, gather {out['gather'][2] * 1e3:.0f} ms)")
    lines.append(f"WORST max_lsb={worst} budget={BUDGET_LSB} -> {'OK' if worst <= BUDGET_LSB else 'FAIL'}")
    return lines, worst


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--aniso", type=int, default=1)
    ap.add_argument("--frames", type=int, default=4)
    _common.add_scene_args(ap)
    args = ap.parse_args(argv)
    opened = _common.open_scene("check_sampler", args)
    if opened is None:
        return 2
    scene, device = opened
    lines, worst = check(scene, scene_name=args.scene, width=args.width, height=args.height, aniso=args.aniso,
                         frames=args.frames, device=device)
    for line in lines:
        print(line)
    return 0 if worst <= BUDGET_LSB else 1


if __name__ == "__main__":
    sys.exit(main())
