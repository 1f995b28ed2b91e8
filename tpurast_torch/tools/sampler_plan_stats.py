"""The windowed sampler's tile plan and the frame time per sampler.

Counterpart of tools/sampler_plan_stats.py: prints the frame time and
window_miss_px with sampler="window" and with sampler="gather", then, on
the window path's G-buffer, the tiles per plan class, the residual pixels
and the histogram of the tiles' probe counts, so a regression in the
window-fit rate shows as numbers. Times are the host's clock around 16
frames with a synchronize after them.

Run: python -m tpurast_torch.tools.sampler_plan_stats [--scene orbit] [--aniso 1] [--angle 0.4]
"""

from __future__ import annotations

import argparse
import collections
import sys
import time

from tpurast_torch.config import RendererConfig
from tpurast_torch.kernels import sampler as ksampler
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import _common

CLASS_NAMES = {0: "A(wide)", 1: "B(tall)", 2: "empty", 3: "RESIDUAL"}


def stats(scene, *, scene_name: str = "orbit", width: int = 1920, height: int = 1080, aniso: int = 1,
          angle: float = 0.4, device="cuda", frames: int = 16) -> list[str]:
    """The reference's printed lines."""
    cam = _common.camera_at(scene_name, angle)
    lines, renderers = [], {}
    for samp in ("window", "gather"):
        cfg = RendererConfig(width=width, height=height, max_anisotropy=aniso, sampler=samp)
        r = renderers[samp] = Renderer(scene, cfg, device=device)
        vp, cp = r.frame_uniforms(cam)
        r.render_with_uniforms(vp, cp)
        _common.sync(device)
        t0 = time.perf_counter()
        for _ in range(frames):
            out = r.render_with_uniforms(vp, cp)
        _common.sync(device)
        ms = (time.perf_counter() - t0) / frames * 1e3
        lines.append(f"{samp}: {ms:.2f} ms/frame  miss_px={int(out['window_miss_px'])}")

    r = renderers["window"]
    plan = ksampler.plan_tiles(r.debug_gbuf(cam), tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=r.config.tile_h,
                               tile_w=r.config.tile_w, max_anisotropy=aniso)
    cls = plan["cls"].cpu().tolist()
    counts = collections.Counter(cls)
    for k in sorted(CLASS_NAMES):
        lines.append(f"class {CLASS_NAMES[k]}: {counts.get(k, 0)} / {len(cls)}")
    lines.append(f"residual_px: {int(plan['residual_px'])}")
    nc = r.config.tile_h // ksampler.rc_for(r.config.tile_h)
    nprobe = plan["table"][:, 1 : 1 + nc, ksampler.CHUNK_NP_LANE].amax(dim=1).cpu().tolist()
    lines.append(f"nprobe histogram: {dict(collections.Counter(nprobe))}")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--aniso", type=int, default=1)
    ap.add_argument("--angle", type=float, default=0.4)
    _common.add_scene_args(ap)
    args = ap.parse_args(argv)
    opened = _common.open_scene("sampler_plan_stats", args)
    if opened is None:
        return 2
    scene, device = opened
    for line in stats(scene, scene_name=args.scene, width=args.width, height=args.height, aniso=args.aniso,
                      angle=args.angle, device=device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
