"""Simulate the window plan's greedy banded covering on a G-buffer dump.

Counterpart of tools/sampler_sim.py. The plan (kernels/sampler.py) places
(texture, mip, texel-rect) windows by greedy banded covering: each round
seeds at the top-left-most uncovered anchor of the lowest uncovered
(texture, mip), opens a window band there and absorbs every pixel whose
whole anchor range fits the window; small mips whose rect fits one window
are covered whole. For candidate window shapes and slot budgets
(WH, WW, K) it reports the tiles that fit, the residual pixels and the
slots per tile. Host only (numpy), on the G-buffer that
tools/residual_analysis.py keeps (run that first, with the same --scene,
--seed, size and --angle).

Run: python -m tpurast_torch.tools.sampler_sim [--scene orbit] [--angle 0.4]
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np

from tpurast_torch.device.scene_cache import SCENES
from tpurast_torch.tools.residual_analysis import gbuf_path

ALIGN_Y = 8
ALIGN_X = 128
# Candidate (window height, window width, slot budget).
CANDIDATES = ((96, 384, 8), (96, 384, 12), (96, 256, 12), (64, 384, 12), (128, 512, 8))


def simulate(gbuf: np.ndarray, *, tile_h: int = 32, tile_w: int = 128) -> list[str]:
    """The reference's printed lines for a (24, Hp, Wp) G-buffer."""
    th, tw = tile_h, tile_w
    tiles_y, tiles_x = gbuf.shape[1] // th, gbuf.shape[2] // tw
    matched = gbuf[16] > 0
    u, v = gbuf[6], gbuf[7]
    tw0, th0 = gbuf[9], gbuf[10]
    tw1, th1 = gbuf[11], gbuf[12]
    l0 = gbuf[19].astype(np.int64)
    l1 = np.where((tw1 == tw0) & (th1 == th0), l0, l0 + 1)
    texid = gbuf[18].astype(np.int64)

    def anchors(uu, vv, ww, hh):
        x0 = np.mod(np.floor(uu * ww - 0.5), np.maximum(ww, 1.0))
        return x0, np.mod(np.floor(vv * hh - 0.5), np.maximum(hh, 1.0))

    x0o, y0o = anchors(u, v, tw0, th0)
    x0p, y0p = anchors(u, v, tw1, th1)
    key_o = texid * 32 + l0
    key_p = texid * 32 + l1
    lines = []
    for wh, ww, k_slots in CANDIDATES:
        cov_y = wh - ALIGN_Y
        cov_x = ww - ALIGN_X
        small_o = (tw0 <= cov_x - 2) & (th0 <= cov_y - 2)
        small_p = (tw1 <= cov_x - 2) & (th1 <= cov_y - 2)
        slot_hist, resid_tiles, resid_px, covered_tiles = [], 0, 0, 0
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                sl = np.s_[ty * th : (ty + 1) * th, tx * tw : (tx + 1) * tw]
                m = matched[sl].ravel()
                if not m.any():
                    continue
                covered_tiles += 1
                keys = np.concatenate([key_o[sl].ravel()[m], key_p[sl].ravel()[m]])
                xs = np.concatenate([x0o[sl].ravel()[m], x0p[sl].ravel()[m]])
                ys = np.concatenate([y0o[sl].ravel()[m], y0p[sl].ravel()[m]])
                small = np.concatenate([small_o[sl].ravel()[m], small_p[sl].ravel()[m]])
                todo = np.ones(keys.shape[0], bool)
                nslots = 0
                while todo.any() and nslots <= 40:
                    nslots += 1
                    k = keys[todo].min()
                    mk = todo & (keys == k)
                    if small[mk].any():
                        todo &= ~mk
                        continue
                    ymin = ys[mk].min()
                    band = mk & (ys < ymin + cov_y - 1)  # whole range fits
                    xmin = xs[band].min()
                    todo &= ~(band & (xs < xmin + cov_x - 1))
                slot_hist.append(nslots)
                if nslots > k_slots:
                    resid_tiles += 1
                    resid_px += int(m.sum())
        sh = np.array(slot_hist)
        hist = dict(sorted(collections.Counter(sh.tolist()).items()))
        tot_px = int(matched.sum())
        lines.append(
            f"WH={wh} WW={ww} K={k_slots}: fit {covered_tiles - resid_tiles}/{covered_tiles}"
            f" tiles, residual {resid_tiles} tiles / {resid_px}px"
            f" ({100 * resid_px / tot_px:.2f}%), slots p50={int(np.percentile(sh, 50))}"
            f" p90={int(np.percentile(sh, 90))} max={sh.max()}, mean={sh.mean():.2f}"
        )
        lines.append(f"  slots hist: { {k: n for k, n in hist.items() if k <= 24} }")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="orbit", choices=list(SCENES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--angle", type=float, default=0.4)
    ap.add_argument("--tile-h", type=int, default=32)
    ap.add_argument("--tile-w", type=int, default=128)
    ap.add_argument("--gbuf-dir", default=None, help="where residual_analysis kept the G-buffer")
    args = ap.parse_args(argv)
    path = gbuf_path(args.gbuf_dir, args.scene, args.seed, args.width, args.height, args.angle)
    if not path.exists():
        print(f"sampler_sim: no G-buffer dump at {path}; run tpurast_torch.tools.residual_analysis with the same "
              "options first", file=sys.stderr)
        return 2
    for line in simulate(np.load(path)["gbuf"], tile_h=args.tile_h, tile_w=args.tile_w):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
