"""Classify per-pixel anisotropic footprints of a rendered G-buffer.

Counterpart of tools/aniso_mode_stats.py, for the separable-footprint
sampler question: a pixel whose footprint line has a cross-axis texel
extent <= tau could be filtered with an axis-aligned trapezoid instead of
a probe loop. Prints, for the own and the parent mip, how many matched
pixels are isotropic / x-separable / y-separable / diagonal, the probe
counts of the diagonal remainder and the x extents of the x-separable
pixels, as one JSON object.

Run: python -m tpurast_torch.tools.aniso_mode_stats [--scene orbit] [--width 1920] [--height 1080]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tpurast_torch import math3d
from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.kernels import shade
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import _common


def view_camera(scene_name: str):
    """The reference's camera: 2.5 units behind the origin looking along
    the world's forward axis; on the orbit scene, orbit_track's first."""
    if scene_name == "orbit":
        return _common.camera_at("orbit", 0.3)
    fwd = math3d.WORLD_SPACE.forward.vector()
    return Camera.from_target(fwd * -2.5, fwd)


def stats(scene, *, scene_name: str = "orbit", width: int = 1920, height: int = 1080, max_anisotropy: int = 16,
          tau: float = 1.0, device="cuda") -> dict:
    """The reference's statistics dict."""
    r = Renderer(scene, RendererConfig(width=width, height=height, max_anisotropy=max_anisotropy), device=device)
    gt = r.debug_gbuf(view_camera(scene_name))
    n_px = shade.probe_count(gt[17], gt[14], gt[15], gt[9], gt[10], max_anisotropy).cpu().numpy()
    g = gt.cpu().numpy()
    matched = g[16] > 0.0
    span = g[17]
    out = {"matched": int(matched.sum())}
    for lvl, (wi, hi) in {"own": (9, 10), "parent": (11, 12)}.items():
        ex = np.abs(g[14]) * span * g[wi]
        ey = np.abs(g[15]) * span * g[hi]
        iso = matched & (n_px <= 1)
        aniso = matched & (n_px > 1)
        xsep = aniso & (ey <= tau)
        ysep = aniso & (ex <= tau) & ~xsep
        diag = aniso & ~xsep & ~ysep
        out[lvl] = {
            "iso": int(iso.sum()),
            "xsep": int(xsep.sum()),
            "ysep": int(ysep.sum()),
            "diag": int(diag.sum()),
            "diag_np_hist": np.bincount(n_px[diag].astype(np.int64), minlength=17)[1:].tolist(),
            "xsep_n_hist": np.bincount(np.ceil(np.clip(ex[xsep], 1, 16)).astype(np.int64), minlength=17)[1:].tolist(),
        }
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--max-anisotropy", type=int, default=16)
    ap.add_argument("--tau", type=float, default=1.0)
    _common.add_scene_args(ap)
    args = ap.parse_args(argv)
    opened = _common.open_scene("aniso_mode_stats", args)
    if opened is None:
        return 2
    scene, device = opened
    print(json.dumps(stats(scene, scene_name=args.scene, width=args.width, height=args.height,
                           max_anisotropy=args.max_anisotropy, tau=args.tau, device=device), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
