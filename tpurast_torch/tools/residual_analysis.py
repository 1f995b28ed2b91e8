"""Why do tiles miss the windowed sampler? Per-tile footprint analysis.

Counterpart of tools/residual_analysis.py: renders one forward G-buffer
(and face ids), computes per-face UV charts on the host
(device/charts.py) and reports, per framebuffer tile, how many distinct
(chart, mip) and (texture, mip) sampling jobs it needs and how big each
job's texel box is, and how many covered tiles candidate window shapes
would fit. This is the data that sizes the window plan's slot count and
window shape (kernels/sampler.py).

The G-buffer is kept as an .npz under --gbuf-dir (default the scene
cache's directory, device/scene_cache.py, which .gitignore lists) and
read back on the next run with the same scene, seed, size and angle;
tools/sampler_sim.py reads the same file.

Run: python -m tpurast_torch.tools.residual_analysis [--scene orbit] [--angle 0.4]
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import sys

import numpy as np

from tpurast_torch.config import RendererConfig
from tpurast_torch.device.charts import face_charts
from tpurast_torch.device.scene_cache import cache_dir
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import _common

# Candidate (slots, window height, window width) of the fit count.
CANDIDATES = ((6, 48, 384), (8, 48, 384), (8, 64, 384), (12, 64, 384))


def gbuf_path(gbuf_dir, scene_name: str, seed: int, width: int, height: int, angle: float) -> pathlib.Path:
    """The G-buffer dump of one scene, size and camera angle."""
    name = f"gbuf_{scene_name}_{seed}_{width}x{height}_{angle}.npz"
    return pathlib.Path(cache_dir() if gbuf_dir is None else gbuf_dir) / name


def _bbox_need(uu, vv, ww, hh, m):
    """Wrapped bilinear anchor box (texels incl. the +1 ghost) of the
    masked pixels: (x_need, y_need)."""
    if not m.any():
        return 0, 0
    x0 = np.mod(np.floor(uu[m] * ww[m] - 0.5), np.maximum(ww[m], 1.0))
    y0 = np.mod(np.floor(vv[m] * hh[m] - 0.5), np.maximum(hh[m], 1.0))
    return int(x0.max() - x0.min()) + 2, int(y0.max() - y0.min()) + 2


def analyse(scene, *, scene_name: str = "orbit", seed: int = 0, width: int = 1920, height: int = 1080,
            angle: float = 0.4, device="cuda", gbuf_dir=None) -> list[str]:
    """The reference's printed lines."""
    lines = []
    cfg = RendererConfig(width=width, height=height)
    path = gbuf_path(gbuf_dir, scene_name, seed, width, height, angle)
    if path.exists():
        d = np.load(path)
        gbuf, fid = d["gbuf"], d["fid"]
        lines.append(f"loaded cached gbuf {path}")
    else:
        r = Renderer(scene, cfg, device=device)
        g, f = r.debug_gbuf(_common.camera_at(scene_name, angle), with_fid=True)
        gbuf, fid = g.cpu().numpy(), f.cpu().numpy()
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, gbuf=gbuf, fid=fid)

    charts = face_charts(scene.faces, scene.n_faces, scene.positions.shape[0])
    lines.append(f"{scene_name}: {scene.n_faces} faces, {int(charts.max()) + 1} charts")
    sizes = np.bincount(charts[: scene.n_faces])
    lines.append("chart sizes: p50=%d p90=%d max=%d" % (int(np.percentile(sizes, 50)), int(np.percentile(sizes, 90)),
                                                        int(sizes.max())))

    th, tw = cfg.tile_h, cfg.tile_w
    tiles_y, tiles_x = gbuf.shape[1] // th, gbuf.shape[2] // tw
    matched = gbuf[16] > 0
    u, v = gbuf[6], gbuf[7]
    tw0, th0 = gbuf[9], gbuf[10]
    tw1, th1 = gbuf[11], gbuf[12]
    l0 = gbuf[19].astype(np.int64)
    l1 = np.where((tw1 == tw0) & (th1 == th0), l0, l0 + 1)
    texid = gbuf[18].astype(np.int64)
    pix_chart = np.where(fid >= 0, charts[np.maximum(fid, 0)], -1).astype(np.int64)

    key_counts_tex, key_counts_chart = [], []
    chart_needs = []  # (x_need, y_need, level, whole_w, whole_h)
    tex_needs = []
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            sl = np.s_[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw]
            m = matched[sl]
            if not m.any():
                continue
            ch, lv0, lv1, txd = pix_chart[sl], l0[sl], l1[sl], texid[sl]
            # own + parent jobs
            keys_c = set(zip(ch[m].tolist(), lv0[m].tolist())) | set(zip(ch[m].tolist(), lv1[m].tolist()))
            keys_t = set(zip(txd[m].tolist(), lv0[m].tolist())) | set(zip(txd[m].tolist(), lv1[m].tolist()))
            key_counts_chart.append(len(keys_c))
            key_counts_tex.append(len(keys_t))
            uu, vv = u[sl], v[sl]
            for ck, lk in keys_c:
                own = m & (ch == ck) & (lv0 == lk)
                par = m & (ch == ck) & (lv1 == lk)
                ww = np.where(own, tw0[sl], tw1[sl])
                hh = np.where(own, th0[sl], th1[sl])
                xn, yn = _bbox_need(uu, vv, ww, hh, own | par)
                any_m = own | par
                chart_needs.append((xn, yn, lk, int(ww[any_m].max()) + 2, int(hh[any_m].max()) + 2))
            for tk, lk in keys_t:
                own = m & (txd == tk) & (lv0 == lk)
                par = m & (txd == tk) & (lv1 == lk)
                ww = np.where(own, tw0[sl], tw1[sl])
                hh = np.where(own, th0[sl], th1[sl])
                xn, yn = _bbox_need(uu, vv, ww, hh, own | par)
                tex_needs.append((xn, yn, lk))

    lines.append(f"per-tile distinct (tex,mip) jobs: {dict(sorted(collections.Counter(key_counts_tex).items()))}")
    lines.append(f"per-tile distinct (chart,mip) jobs: {dict(sorted(collections.Counter(key_counts_chart).items()))}")

    cn = np.array([(x, y) for x, y, *_ in chart_needs])
    tn = np.array([(x, y) for x, y, _ in tex_needs])
    whole = np.array([(w, h) for _, _, _, w, h in chart_needs])
    eff = np.minimum(cn, whole)  # a window over the whole rect is the alternative

    def q(a, p):
        return int(np.percentile(a, p))

    for nm, arr in (("(tex,mip) bbox", tn), ("(chart,mip) bbox", cn), ("chart min(bbox,rect)", eff)):
        lines.append(
            f"{nm} need: x p50={q(arr[:, 0], 50)} p90={q(arr[:, 0], 90)} p99={q(arr[:, 0], 99)} max={arr[:, 0].max()}"
            f" | y p50={q(arr[:, 1], 50)} p90={q(arr[:, 1], 90)} p99={q(arr[:, 1], 99)} max={arr[:, 1].max()}"
        )
    # Covered tiles that fit entirely with each candidate (chart-keyed, the
    # slot budget, alignment slack included).
    for n_slots, wy, wx in CANDIDATES:
        fit_tiles, i = 0, 0
        for cnt in key_counts_chart:
            jobs = chart_needs[i : i + cnt]
            i += cnt
            if cnt > n_slots:
                continue
            fit_tiles += all((x + 127 <= wx and y + 15 <= wy) or (ww <= wx and hh <= wy) for x, y, _, ww, hh in jobs)
        lines.append(f"slots={n_slots} window=({wy},{wx}): {fit_tiles}/{len(key_counts_chart)} covered tiles fit")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--angle", type=float, default=0.4)
    ap.add_argument("--gbuf-dir", default=None, help="where the G-buffer dump is kept (default: the scene cache's)")
    _common.add_scene_args(ap)
    args = ap.parse_args(argv)
    opened = _common.open_scene("residual_analysis", args)
    if opened is None:
        return 2
    scene, device = opened
    for line in analyse(scene, scene_name=args.scene, seed=args.seed, width=args.width, height=args.height,
                        angle=args.angle, device=device, gbuf_dir=args.gbuf_dir):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
