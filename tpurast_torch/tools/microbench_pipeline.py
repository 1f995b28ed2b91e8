"""Launch-geometry cost of a G-buffer plane copy on an NVIDIA GPU.

Counterpart of tools/microbench_pipeline.py: out = 2 * gbuf[16] over a
(24, 1088, 1920) G-buffer, by the plane_scale CUDA kernel
(kernels/probes.py) in the reference's three geometries: 32x128 tile
blocks on the 24-plane buffer ("tile-grid copy"), the same on a one-plane
buffer ("one-plane copy"), and 32x1920 row bands ("row-band copy"). Each
prints one JSON line {label: median ms} over 6 rounds of 4 calls timed
with CUDA events; every output is checked to equal 2 * gbuf[16].

Run: python -m tpurast_torch.tools.microbench_pipeline
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from tpurast_torch.kernels import probes
from tpurast_torch.tools.microbench import cuda_ms, generator


def median_ms(fn) -> float:
    """Median over 6 rounds of the mean ms of 4 calls (CUDA events)."""
    return float(np.median([cuda_ms(fn, 4) for _ in range(6)]))


PLANES, PLANE, TILE_H, TILE_W = 24, 16, 32, 128


def run(device, *, tiles_x: int = 15, tiles_y: int = 34, timer=median_ms) -> dict:
    """{label: ms} of the three launch geometries over a (24, 32 tiles_y,
    128 tiles_x) G-buffer; raises if an output is not exactly
    2 * gbuf[16]."""
    plane, tile_h, tile_w = PLANE, TILE_H, TILE_W
    h, w = tiles_y * tile_h, tiles_x * tile_w
    gbuf = torch.rand((PLANES, h, w), generator=generator(device, 0), device=device)
    one = gbuf[plane : plane + 1].clone()
    cases = {
        "tile-grid copy": lambda: probes.plane_scale(gbuf, plane, block_h=tile_h, block_w=tile_w),
        "one-plane copy": lambda: probes.plane_scale(one, 0, block_h=tile_h, block_w=tile_w),
        "row-band copy": lambda: probes.plane_scale(gbuf, plane, block_h=tile_h, block_w=w),
    }
    want = 2.0 * gbuf[plane : plane + 1]
    out = {}
    for label, fn in cases.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{label}: output differs from 2 * gbuf[{plane}]")
        out[label] = timer(fn)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("microbench_pipeline: torch.cuda.is_available() is false; it times an NVIDIA GPU")
    for label, ms in run(torch.device("cuda")).items():
        print(json.dumps({label: round(ms, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
