"""The frozen bound arithmetic against counts made by hand."""

from __future__ import annotations

import math

import pytest
import torch

from portbench import run, scenes, yardstick
from portbench.reference import render as rrender
from portbench.reference import scene as rscene
from portbench.scenes import tracks

HBM, F32 = 3.35e12, 6.7e13


def test_peaks_are_the_published_ones():
    assert yardstick.PEAKS["hbm_bytes_per_s"] == HBM and yardstick.PEAKS["f32_flops_per_s"] == F32


def test_bounds_by_hand():
    s = dict(hp=64, wp=128, tiles=2, pairs=3, faces=2, evals=5000, covered=1000, covered_faces=7, probes=4000,
             distinct=900, row_format="srgb8")
    px = 64 * 128
    # raster: two faces' 88 bytes, 4 bytes a pair, the offsets, the (2, Hp, Wp) output.
    assert yardstick.raster_bound(s) == pytest.approx(max((2 * 88 + 12 + 12 + 2 * px * 4) / HBM,
                                                          5000 * 40 / F32) * 1e3)
    # sample: the match plane, 20 planes at 1000 covered pixels, tile classes,
    # 900 texels of 8 bytes, the four output planes; 100 operations a probe.
    assert yardstick.sample_bound(s) == pytest.approx(
        max((px * 4 + 20 * 1000 * 4 + 2 * 4 + 900 * 8 + 4 * px * 4) / HBM, 4000 * 100 / F32) * 1e3)
    # deferred: the face ids, 7 rows of 104 floats, 900 rows of 52 bytes and
    # the decode table, the output; 230 operations a pixel, 160 a probe.
    assert yardstick.deferred_bound(s) == pytest.approx(
        max((px * 4 + 7 * 416 + 900 * 52 + 1024 + 4 * px * 4) / HBM, (1000 * 230 + 4000 * 160) / F32) * 1e3)


def test_frame_work_counts_by_hand(tmp_path):
    inputs = scenes.scene_inputs({"kind": "standin_porsche_class", "scale": "small", "textures": 12}, 3, tmp_path)
    dr = rrender.to_device(rscene.from_inputs(inputs), "page", "cpu")
    t = rrender.Target(width=128, height=64)
    track = run.load_json(run.BENCH / "traffic" / "viewer_orbit.json")["track"]
    pos, target = tracks.circle_track(track, 40)[39]
    frame = rrender.render(dr, t, pos, target, want_stats=True)
    s = frame.stats
    vp, _ = rrender.m3.frame_uniforms(pos, target, 128, 64, math.radians(80.0), 0.01)
    setup = rrender.triangle_setup(rrender.transform_corners(dr.corner_world, torch.from_numpy(vp)), dr.n_faces,
                                   128, 64)
    pairs = evals = 0
    faces = set()
    for f in torch.nonzero(setup["valid"])[:, 0].tolist():
        x0, y0, x1, y1 = setup["aabb"][f].tolist()
        rx0, ry0, rx1, ry1 = math.floor(x0) - 1, math.floor(y0) - 1, math.floor(x1) + 1, math.floor(y1) + 1
        for ty in range(2):
            tx = 0
            if math.floor(x1 / 128) < 0 or math.floor(y1 / 32) < 0 or math.floor(x0 / 128) >= 1 or \
                    math.floor(y0 / 32) >= 2:
                continue
            if not (min(max(math.floor(y0 / 32), 0), 1) <= ty <= min(max(math.floor(y1 / 32), 0), 1)):
                continue
            pairs += 1
            faces.add(f)
            w = min(rx1, tx * 128 + 127) - max(rx0, tx * 128) + 1
            h = min(ry1, ty * 32 + 31) - max(ry0, ty * 32) + 1
            evals += max(w, 0) * max(h, 0)
    assert (s["pairs"], s["faces"], s["evals"]) == (pairs, len(faces), evals)
    assert s["covered"] == frame.covered > 0
    assert 0 < s["distinct"] <= 8 * s["probes"]
