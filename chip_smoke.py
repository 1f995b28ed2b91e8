#!/usr/bin/env python3
"""Smoke run of the tpurast_torch paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from tpurast_torch/csrc, builds a procedural scene
from the seed (a 256x256-quad floor and 64 UV spheres, 258,048 triangles,
eight generated 1024^2 BC4 textures with full mip chains), and then, at
1920x1080:

  1. runs one frame's real inputs through each render kernel (raster,
     resolve, plan, sample) and through its plain torch version on the
     same device, and holds the two against each other: raster depth and
     face id exact; resolve integer planes exact, float planes within
     rtol 1e-5 / atol 1e-6 outside pixels whose mip level l0 flipped (at
     most 0.1% of covered pixels); plan table and assignment exact;
     sample within 1 LSB after the sRGB u8 encode, and its frame under
     an all-residual plan equal to the one under the real plan (the plan
     decides nothing but the empty-tile skip); the sample kernel's other
     page layout and warp shapes are timed beside the shipped one;
  2. runs the microbenchmark probes at the tools' sizes against their
     plain versions, bit for bit: vmem_take (4096x16 f32 table, 2,073,600
     indices) and plane_scale on a (24, 1088, 1920) G-buffer in its three
     launch geometries;
  3. the window main path: renders a warm-up frame plus 8 frames of an
     orbiting camera through tpurast_torch.renderer.Renderer, checks that
     every render kernel's launch counter rose by one per frame, that
     nothing overflowed and that 5-95% of the pixels are covered, and
     renders frame 0 again with every kernel's plain version: color
     within 1 LSB, depth exact;
  4. the microbenchmark path: tools.microbench's vmemtake and
     tools.microbench_pipeline's run, with the probe counters from zero
     (each kernel must launch), and tools.microbench's shade
     decomposition over the orbit scene's f16 atlas rows;
  5. the gather path (sampler="gather"): a warm-up frame plus 3 track
     frames; raster and resolve launch once per frame, plan and sample
     never; no overflow; depth equal to the window path's; frame 0 within
     2 LSB of the window path's frame 0 (the reference's budget between
     its two samplers, tests/test_sampler.py:76);
  6. the deferred path (shading="deferred"), the same frames: raster
     launches once per frame and nothing else; color and depth equal to
     the gather path's bit for bit.

Each path prints its frame times and a per-stage breakdown; the window
path also prints, per stage, the device operations torch.profiler counts
and their device time beside the stage's event time. Earlier lines give
the plan and sample kernels' registers and resident blocks per SM, the
plan's windows-per-tile histogram and the probes a warp runs (its worst
lane's) beside the mean per pixel. Each kernel
also gets its bound: the larger of the bytes it must move over the card's
memory rate and its f32 operations over the f32 peak (HBM_BYTES_PER_S,
F32_FLOPS), from this run's inputs (plan and sample: the planes the
function needs, not all 24, and for sample the distinct page texels its
probes touch; the earlier count is printed beside it); the raster line adds the densest
tile's pair count, the (pair, pixel) evaluations of the pairs' pixel
rectangles and the kernel's device time by operation, and plane_scale is
timed beside torch.mul(gbuf[plane], 2), the one PyTorch call that computes
the same. Any failure raises. The last stdout line is {"ok": true,
"device": ...}; the line before it lists each kernel's launches, error,
times, bound and library time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpurast_torch import kernels as K  # noqa: E402
from tpurast_torch.config import RendererConfig  # noqa: E402
from tpurast_torch.device.scene import build_orbit_scene, orbit_track  # noqa: E402
from tpurast_torch.kernels import _build, geometry, present, probes, raster, resolve, sampler, shade  # noqa: E402
from tpurast_torch.renderer import Renderer  # noqa: E402
from tpurast_torch.tools import microbench, microbench_pipeline  # noqa: E402
from tpurast_torch.tools.microbench import device_ms  # noqa: E402

KERNELS = {
    "raster": ("tpurast_torch/csrc/raster.cu", "tpurast/kernels/raster.py:88"),
    "resolve": ("tpurast_torch/csrc/resolve.cu", "tpurast/kernels/resolve.py:126"),
    "plan": ("tpurast_torch/csrc/plan.cu", "tpurast/kernels/sampler.py:230"),
    "sample": ("tpurast_torch/csrc/sampler.cu", "tpurast/kernels/sampler.py:650"),
    "vmem_take": ("tpurast_torch/csrc/probes.cu", "tools/microbench.py:262"),
    "plane_scale": ("tpurast_torch/csrc/probes.cu", "tools/microbench_pipeline.py:35"),
}
RENDER_KERNELS = ("raster", "resolve", "plan", "sample")
# The card's published peaks (H100 SXM at 700 W): device memory bytes/s
# and f32 FLOP/s outside the tensor cores. A kernel's bound is the larger of its bytes and its operations
# over these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per evaluated (pair, pixel) of the raster kernel: three
# edge functions, their sum, the depth and w numerators, the w test and
# the division (csrc/raster.cu).
RASTER_FLOPS_PER_EVAL = 40
# Bytes of one face the raster kernel must read: setup fields 0-17 (edges,
# z, w, face id, anchor; kRowFields in csrc/raster.cu) and its AABB.
RASTER_FACE_BYTES = 18 * 4 + 4 * 4
PROBE_KERNELS = ("vmem_take", "plane_scale")
FRAMES = 8
GATHER_FRAMES = 3
WIDTH, HEIGHT = 1920, 1080
FLOAT_PLANES = [i for i in range(resolve.A_OUT) if i not in resolve.INT_PLANES]
# G-buffer planes the functions read: the plan 6, 7, 9-12, 14-17, 20-23; the
# sample those and 0-5 and 13 (csrc/plan.cu, csrc/sampler.cu).
PLAN_PLANES = 14
SAMPLE_PLANES = 21


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn over reps calls, by CUDA events,
    after one warm-up call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ops(fn, reps: int) -> dict:
    """Device milliseconds per call of fn by operation name (torch.profiler
    over reps calls after one warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages() if e.self_device_time_total > 0}


def timed(kernel_fn, plain_fn, reps: int, plain_reps: int) -> dict:
    """A kernel's and its plain version's ms per call by CUDA events (ms,
    plain_ms: what a caller waits, launch overhead included) and by the
    profiler's device time (dev_ms, plain_dev_ms)."""
    return dict(
        ms=cuda_ms(kernel_fn, reps), plain_ms=cuda_ms(plain_fn, plain_reps),
        dev_ms=device_ms(kernel_fn, reps), plain_dev_ms=device_ms(plain_fn, plain_reps),
    )


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def raster_work(so, bins, th, tw, tx) -> dict:
    """Pairs, the distinct faces they name, the densest tile's pair count,
    the (pair, pixel) evaluations the raster kernel makes (each pair's
    pixel rectangle, raster.pixel_rects, clamped to its tile) and its work
    units (tile, chunk of pairs)."""
    n = int(bins["offsets"][-1])
    faces = bins["pair_faces"][:n].long()
    tiles = bins["pair_tiles"][:n].long()
    r = raster.pixel_rects(so["aabb"])[faces]
    gx0 = ((tiles % tx) * tw).float()
    gy0 = ((tiles // tx) * th).float()
    w = torch.minimum(r[:, 2], gx0 + (tw - 1)) - torch.maximum(r[:, 0], gx0) + 1
    h = torch.minimum(r[:, 3], gy0 + (th - 1)) - torch.maximum(r[:, 1], gy0) + 1
    evals = int((w.clamp(min=0).double() * h.clamp(min=0).double()).sum())
    units = int(((bins["counts"] + raster.UNIT_PAIRS - 1) // raster.UNIT_PAIRS).sum())
    return dict(pairs=n, faces=int(torch.unique(faces).numel()), densest=int(bins["counts"].max()), evals=evals,
                units=units)


@contextlib.contextmanager
def plain_kernels():
    """Route render_frame's kernel calls to their plain torch versions."""
    swaps = [
        (raster, "rasterize_tiles", raster.rasterize_tiles_plain),
        (resolve, "resolve_gbuffer", resolve.resolve_gbuffer_plain),
        (sampler, "plan_tiles", sampler.plan_tiles_plain),
        (sampler, "sample_tiles", sampler.sample_tiles_plain),
        (probes, "vmem_take", probes.vmem_take_plain),
        (probes, "plane_scale", probes.plane_scale_plain),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_phases(r: Renderer, cam) -> dict:
    """Each kernel against its plain version on frame 0's real inputs."""
    kw = r._frame_kwargs
    sc = r.scene
    vp, cp = r.frame_uniforms(cam)
    th, tw, tx, ty = kw["tile_h"], kw["tile_w"], r.tiles_x, r.tiles_y
    clip = geometry.transform_corners(sc["corner_world"], vp)
    so = geometry.triangle_setup(clip, None, sc["n_faces"], kw["width"], kw["height"])
    bins = geometry.bin_pairs(so["aabb"], so["valid"], tx, ty, tw, th)
    rkw = dict(tile_h=th, tile_w=tw, tiles_x=tx, tiles_y=ty, clear_depth=kw["clear_depth"])
    out = {}

    vis = raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], **rkw)
    vis_p = raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], **rkw)
    torch.cuda.synchronize()
    fid_bad = int((vis[1] != vis_p[1]).sum())
    depth_bad = int((vis[0] != vis_p[0]).sum())
    depth_err = float((vis[0] - vis_p[0]).abs().max())
    covered = int((vis[1] >= 0).sum())
    work = raster_work(so, bins, th, tw, tx)
    hp, wp = vis.shape[1:]
    out["raster"] = dict(
        max_abs_err=depth_err, library_ms=None,
        # Each input read once: the named faces' rows and AABBs, the pair
        # list and offsets; the (2, Hp, Wp) output written once.
        **bound(work["faces"] * RASTER_FACE_BYTES + work["pairs"] * 4 + (tx * ty + 1) * 4 + 2 * hp * wp * 4,
                work["evals"] * RASTER_FLOPS_PER_EVAL),
        **timed(
            lambda: raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], **rkw),
            lambda: raster.rasterize_tiles_plain(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"], **rkw),
            20, 2,
        ),
    )
    st = out["raster"]
    print(f"raster: pairs {work['pairs']} of {work['faces']} faces (per tile mean {work['pairs'] / (tx * ty):.0f}, "
          f"densest tile "
          f"{work['densest']}), work units {work['units']}, evaluated (pair, pixel) {work['evals']}, "
          f"covered px {covered}; vs plain: "
          f"face id differs at {fid_bad} px, depth at {depth_bad} px, max abs diff {depth_err}; "
          f"{st['ms']:.4f} ms (device {fmt_ms(st['dev_ms'])}) vs plain {st['plain_ms']:.3f} ms; bound "
          f"{st['bound_ms']:.4f} ms by {st['bound_by']}, {st['bound_ms'] / st['ms']:.4f} of it")
    ops = device_ops(lambda: raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"],
                                                    **rkw), 20)
    print("raster device ms by operation: " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in ops.items()))
    check(fid_bad == 0 and depth_bad == 0, "raster kernel disagrees with its plain version")

    attrs = resolve.pack_resolve_attrs(
        so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"], sc["face_tex"], sc["atlas"]
    )
    ma = kw["max_anisotropy"]
    g = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma)
    g_p = resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=ma)
    torch.cuda.synchronize()
    flip = (g[19] != g_p[19]) & (vis[1] >= 0)
    n_flip = int(flip.sum())
    keep = ~flip
    int_bad = int(sum(((g[i] != g_p[i]) & keep).sum() for i in resolve.INT_PLANES))
    gf, gpf = g[FLOAT_PLANES][:, keep], g_p[FLOAT_PLANES][:, keep]
    float_bad = int((~torch.isclose(gf, gpf, rtol=1e-5, atol=1e-6)).sum())
    res_err = float((gf - gpf).abs().max())
    fid = vis[1][vis[1] >= 0].long()
    out["resolve"] = dict(
        max_abs_err=res_err, library_ms=None,
        # vis read, the attribute rows of the visible faces, the G-buffer written;
        # ~150 flops per covered pixel (csrc/resolve.cu).
        **bound(2 * hp * wp * 4 + int(torch.unique(fid).numel()) * attrs.shape[1] * 4 + g.numel() * 4,
                covered * 150),
        **timed(
            lambda: resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma),
            lambda: resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=ma),
            20, 3,
        ),
    )
    print(f"resolve: vs plain: l0 flips at {n_flip} px ({n_flip / max(covered, 1):.2e} of covered), "
          f"integer-plane values differing {int_bad}, float-plane values outside rtol 1e-5/atol 1e-6 "
          f"{float_bad}, max abs diff {res_err}; "
          f"{out['resolve']['ms']:.3f} ms vs plain {out['resolve']['plain_ms']:.3f} ms")
    check(n_flip <= 0.001 * covered and int_bad == 0 and float_bad == 0,
          "resolve kernel disagrees with its plain version")

    tiles = dict(tiles_x=tx, tiles_y=ty, tile_h=th, tile_w=tw)
    plan = sampler.plan_tiles(g, max_anisotropy=ma, **tiles)
    plan_p = sampler.plan_tiles_plain(g, max_anisotropy=ma, **tiles)
    torch.cuda.synchronize()
    table_bad = int((plan["table"] != plan_p["table"]).sum())
    assign_bad = int((plan["assign"] != plan_p["assign"]).sum())
    n_matched = int((g[16] > 0).sum())
    plan_out_bytes = plan["table"].numel() * 4 + plan["assign"].numel() * 4
    plan_bound_all = bound(g.numel() * 4 + plan_out_bytes, hp * wp * 100)  # counted with all 24 planes
    plan_bound_planes = bound(PLAN_PLANES * hp * wp * 4 + plan_out_bytes, hp * wp * 100)
    out["plan"] = dict(
        max_abs_err=float((plan["assign"] - plan_p["assign"]).abs().max()), library_ms=None,
        # What this frame needs: the match plane read at every pixel, the
        # other PLAN_PLANES - 1 planes at the matched pixels, the table and
        # assignment written; its reductions are a few operations per pixel
        # and round.
        **bound(hp * wp * 4 + (PLAN_PLANES - 1) * n_matched * 4 + plan_out_bytes, hp * wp * 100),
        **timed(
            lambda: sampler.plan_tiles(g, max_anisotropy=ma, **tiles),
            lambda: sampler.plan_tiles_plain(g, max_anisotropy=ma, **tiles),
            20, 3,
        ),
    )
    cls = plan["cls"]
    n_used = plan["n_used"][cls == sampler.CLS_WINDOWED].float()
    st = out["plan"]
    print(f"plan: tiles windowed {int((cls == sampler.CLS_WINDOWED).sum())}, residual "
          f"{int((cls == sampler.CLS_RESIDUAL).sum())} ({int(plan['residual_px'])} px), empty "
          f"{int((cls == sampler.CLS_EMPTY).sum())}; windows per windowed tile mean {float(n_used.mean()):.2f} "
          f"max {int(n_used.max())}; vs plain: table words differing {table_bad}, assignments differing "
          f"{assign_bad}; {st['ms']:.4f} ms (device {fmt_ms(st['dev_ms'])}) vs plain {st['plain_ms']:.3f} ms; "
          f"bound {st['bound_ms']:.4f} ms by {st['bound_by']} (plane 16 everywhere, {PLAN_PLANES - 1} planes at "
          f"the {n_matched} matched px; {PLAN_PLANES} planes at every px: {plan_bound_planes['bound_ms']:.4f} ms; "
          f"all 24, as counted before: {plan_bound_all['bound_ms']:.4f} ms)")
    ops = device_ops(lambda: sampler.plan_tiles(g, max_anisotropy=ma, **tiles), 20)
    print("plan device ms by operation: " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in ops.items()))
    # The kernel's floor: every tile empty (one barrier, then the table and
    # assignment writes), against this frame's covered tiles.
    g_empty = g.clone()
    g_empty[16] = 0.0
    empty_ms = device_ms(lambda: sampler.plan_tiles(g_empty, max_anisotropy=ma, **tiles), 20)
    del g_empty
    print(f"plan on the same G-buffer with no pixel matched (all {tx * ty} tiles empty): device {fmt_ms(empty_ms)} ms")
    hist = torch.bincount(plan["n_used"][cls != sampler.CLS_EMPTY].long(), minlength=sampler.K2 + 1).tolist()
    print("plan: covered tiles by windows used (0..32): " + " ".join(str(n) for n in hist))
    check(table_bad == 0 and assign_bad == 0, "plan kernel disagrees with its plain version")

    skw = dict(
        max_anisotropy=ma, light_direction=kw["light_direction"], light_color=kw["light_color"],
        ambient_amount=kw["ambient_amount"], specular_power=kw["specular_power"],
        clear_color=kw["clear_color"], blend=kw["blend"], **tiles,
    )
    page = sc["atlas"]["page"]
    probe_map = torch.where(g[16] > 0, shade.probe_count(g[17], g[14], g[15], g[9], g[10], ma), 0.0)
    n_probe = probe_map[g[16] > 0]
    fb = sampler.sample_tiles(g, page, plan, cp, **skw)
    fb_p = sampler.sample_tiles_plain(g, page, plan, cp, **skw)
    w, h = kw["width"], kw["height"]
    enc_diff = (present.encode_srgb_u8(fb, w, h).int() - present.encode_srgb_u8(fb_p, w, h).int()).abs()
    lsb = int(enc_diff.max())
    px_bad = int((enc_diff.amax(dim=0) > 0).sum())
    smp_err = float((fb - fb_p).abs().max())
    sample_flops = float(n_probe.sum()) * 100
    # Counted as before: all 24 planes, the assignment and table, no texels.
    sample_bound_all = bound((g.numel() + plan["assign"].numel() + plan["table"].numel()) * 4 + fb.numel() * 4,
                             sample_flops)
    texel_bytes = touched_page_bytes(g, page, ma)
    sample_bound_planes = bound(SAMPLE_PLANES * hp * wp * 4 + tx * ty * 4 + texel_bytes + fb.numel() * 4,
                                sample_flops)
    out["sample"] = dict(
        max_abs_err=smp_err, library_ms=None,
        # What this frame needs: the match plane at every pixel, the other
        # SAMPLE_PLANES - 1 planes at the matched pixels, each tile's class,
        # every distinct page texel the probes touch read once (8 bytes),
        # the framebuffer written; per probe 2 mips x 4 texels x 4 channels
        # of multiply-adds plus the weights, ~100 flops.
        **bound(hp * wp * 4 + (SAMPLE_PLANES - 1) * n_matched * 4 + tx * ty * 4 + texel_bytes + fb.numel() * 4,
                sample_flops),
        **timed(
            lambda: sampler.sample_tiles(g, page, plan, cp, **skw),
            lambda: sampler.sample_tiles_plain(g, page, plan, cp, **skw),
            20, 3,
        ),
    )
    st = out["sample"]
    print(f"sample: probes per covered px mean {float(n_probe.mean()):.2f} max {float(n_probe.max()):.0f}, "
          f"mip levels in view {sorted(int(x) for x in torch.unique(g[19][g[16] > 0]).tolist())}; "
          f"vs plain: {px_bad} px differ after the u8 encode, max {lsb} LSB, linear max abs diff {smp_err}; "
          f"{st['ms']:.4f} ms (device {fmt_ms(st['dev_ms'])}) vs plain {st['plain_ms']:.3f} ms; bound "
          f"{st['bound_ms']:.4f} ms by {st['bound_by']} (plane 16 everywhere, {SAMPLE_PLANES - 1} planes at the "
          f"{n_matched} matched px, {texel_bytes} B of distinct page texels of a {page.numel() * 2} B page; "
          f"{SAMPLE_PLANES} planes at every px: {sample_bound_planes['bound_ms']:.4f} ms; all 24 and the plan, no "
          f"texels, as counted before: {sample_bound_all['bound_ms']:.4f} ms)")
    check(lsb <= 1, "sample kernel disagrees with its plain version")
    # A warp runs as many probe rounds as its worst lane needs.
    for ww, wh in ((32, 1), (8, 4)):
        worst = probe_map.reshape(hp // wh, wh, wp // ww, ww).amax(dim=(1, 3))
        worst = worst[worst > 0]
        print(f"sample: probes per warp of {ww}x{wh} px (worst lane), mean over the {worst.numel()} warps with a "
              f"covered px {float(worst.mean()):.2f}, {float(worst.mean()) / float(n_probe.mean()):.2f} of the mean "
              f"per covered px")

    # The frame does not depend on the plan: with every windowed tile marked
    # residual the kernel must give the same frame bit for bit.
    table = plan["table"].clone()
    table[:, 0, 0] = torch.where(table[:, 0, 0] == sampler.CLS_WINDOWED, sampler.CLS_RESIDUAL, table[:, 0, 0])
    forced = dict(plan, table=table)
    fb_r = sampler.sample_tiles(g, page, forced, cp, **skw)
    same = bool(torch.equal(fb_r, fb))
    direct_ms = cuda_ms(lambda: sampler.sample_tiles(g, page, forced, cp, **skw), 20)
    print(f"sample under an all-residual plan: frame equal to the one under the real plan {same}; "
          f"{direct_ms:.4f} ms vs {st['ms']:.4f} ms")
    check(same, "the sampled frame depends on the plan")
    return out


def touched_page_bytes(g, page, ma) -> int:
    """Bytes of the distinct page texels (4 bf16 channels each) that the
    matched pixels' probes touch, own and parent mip, from the plain
    version's tap positions."""
    gm = g[:, g[16] > 0]
    n_px = shade.probe_count(gm[17], gm[14], gm[15], gm[9], gm[10], ma)
    touched = torch.zeros(page.shape[1:], dtype=torch.bool, device=g.device)
    for i in range(int(n_px.max()) if n_px.numel() else 0):
        live = i < n_px
        for ww, hh, by, bx in ((9, 10, 20, 21), (11, 12, 22, 23)):
            py, px, _, _ = sampler.tap_position(i, gm[6], gm[7], gm[14], gm[15], gm[17], n_px, gm[ww], gm[hh],
                                                gm[by], gm[bx])
            py, px = py[live], px[live]
            for dy in (0, 1):
                for dx in (0, 1):
                    touched[py + dy, px + dx] = True
    return int(touched.sum()) * 8


def probe_phases(dev) -> dict:
    """vmem_take and the three plane_scale geometries against their plain
    versions at the tools' sizes (tools/microbench.py cmd_vmemtake,
    tools/microbench_pipeline.py main): bit for bit."""
    out = {}
    n = microbench.N_PX
    table = torch.rand((4096, 16), generator=microbench.generator(dev, 1), device=dev)
    idx = microbench.randint(4096, n, dev, 0)
    got, want = probes.vmem_take(table, idx), probes.vmem_take_plain(table, idx)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    out["vmem_take"] = dict(
        max_abs_err=float((got - want).abs().max()), library_ms=None,  # table.sum(1)[idx] is two calls
        **bound(table.numel() * 4 + idx.numel() * 4 + n * 4, n * 15),
        **timed(
            lambda: probes.vmem_take(table, idx),
            lambda: probes.vmem_take_plain(table, idx),
            20, 5,
        ),
    )
    print(f"vmem_take: {n} indices into a 4096x16 f32 table; vs plain: {bad} sums differ, max abs diff "
          f"{out['vmem_take']['max_abs_err']}; {out['vmem_take']['ms']:.4f} ms vs plain "
          f"{out['vmem_take']['plain_ms']:.4f} ms")
    check(bad == 0, "vmem_take kernel disagrees with its plain version")

    gbuf = torch.rand((24, 1088, 1920), generator=microbench.generator(dev, 0), device=dev)
    one = gbuf[16:17].clone()
    geoms = {
        "tile-grid (24-plane buffer, 32x128 blocks)": (gbuf, 16, 32, 128),
        "one-plane (1-plane buffer, 32x128 blocks)": (one, 0, 32, 128),
        "row-band (24-plane buffer, 32x1920 blocks)": (gbuf, 16, 32, 1920),
    }
    rows = []
    for label, (src, plane, bh, bw) in geoms.items():
        got = probes.plane_scale(src, plane, block_h=bh, block_w=bw)
        want = probes.plane_scale_plain(src, plane, block_h=bh, block_w=bw)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        # The one-call yardstick, timed like the kernel (50 repeated calls,
        # so its 16.7 MB come from L2 after the first).
        lib = lambda: torch.mul(src[plane], 2)  # noqa: E731
        rows.append(dict(
            max_abs_err=float((got - want).abs().max()),
            library_ms=cuda_ms(lib, 50), library_dev_ms=device_ms(lib, 50),
            **bound(8 * src.shape[1] * src.shape[2], src.shape[1] * src.shape[2]),
            **timed(
                lambda: probes.plane_scale(src, plane, block_h=bh, block_w=bw),
                lambda: probes.plane_scale_plain(src, plane, block_h=bh, block_w=bw),
                50, 50,
            ),
        ))
        r = rows[-1]
        print(f"plane_scale {label}: equal to plain {same}; {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms "
              f"vs torch.mul {r['library_ms']:.4f} ms; device {fmt_ms(r['dev_ms'])} ms vs plain "
              f"{fmt_ms(r['plain_dev_ms'])} ms vs torch.mul {fmt_ms(r['library_dev_ms'])} ms; bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
        check(same, f"plane_scale {label} disagrees with its plain version")
    # Rectangles whose rows leave the 16-byte grid take the kernel's scalar
    # head and tail (odd width, blocks narrower than 4, a plane offset of 1
    # mod 4 floats): held to the plain version too, small and untimed.
    off_grid = [((3, 67, 381), 1, 32, 128), ((3, 67, 381), 2, 7, 3), ((3, 15, 23), 1, 5, 2)]
    for k, (shape, plane, bh, bw) in enumerate(off_grid):
        src = torch.rand(shape, generator=microbench.generator(dev, 2 + k), device=dev)
        same = bool(torch.equal(probes.plane_scale(src, plane, block_h=bh, block_w=bw),
                                probes.plane_scale_plain(src, plane, block_h=bh, block_w=bw)))
        print(f"plane_scale off the 16-byte grid, {shape} plane {plane}, {bh}x{bw} blocks: equal to plain {same}")
        check(same, f"plane_scale {shape} {bh}x{bw} disagrees with its plain version")
    out["plane_scale"] = dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))
    return out


def frame_stages(r: Renderer, vp, cp):
    """One frame of r's configured path, stage by stage (the stages of
    render_frame): yields each stage's name once its work is enqueued."""
    kw = r._frame_kwargs
    sc = r.scene
    ma = kw["max_anisotropy"]
    tiles = dict(tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"])
    light = dict(light_direction=kw["light_direction"], light_color=kw["light_color"],
                 ambient_amount=kw["ambient_amount"], specular_power=kw["specular_power"],
                 clear_color=kw["clear_color"], blend=kw["blend"])
    clip = geometry.transform_corners(sc["corner_world"], vp)
    so = geometry.triangle_setup(clip, None, sc["n_faces"], kw["width"], kw["height"])
    yield "geometry"
    bins = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"])
    yield "binning"
    vis = raster.rasterize_tiles(so["setup"], so["aabb"], bins["pair_faces"], bins["offsets"],
                                 clear_depth=kw["clear_depth"], **tiles)
    yield "raster"
    corners = (so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"], sc["face_tex"], sc["atlas"])
    if kw["shading"] == "forward":
        attrs = resolve.pack_resolve_attrs(*corners)
        yield "pack_attrs"
        g = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma)
        yield "resolve"
        if kw["sampler"] == "window":
            plan = sampler.plan_tiles(g, max_anisotropy=ma, **tiles)
            yield "plan"
            fb = sampler.sample_tiles(g, sc["atlas"]["page"], plan, cp, max_anisotropy=ma, **light, **tiles)
            yield "sample"
        else:
            fb = shade.shade_gbuffer(g, sc["atlas"]["texels"], cp, max_anisotropy=ma,
                                     texel_format=kw["texture_format"], **light)
            yield "shade_gbuffer"
    else:
        rows = shade.pack_shade_rows(*corners)
        yield "pack_shade_rows"
        fb = shade.shade_deferred(vis[1].to(torch.int32), rows, sc["atlas"]["texels"], cp, max_anisotropy=ma,
                                  texel_format=kw["texture_format"], **light)
        yield "shade_deferred"
    present.encode_srgb_u8(fb, kw["width"], kw["height"])
    yield "encode"


def stage_breakdown(r: Renderer, cam, reps: int = 5) -> dict:
    """Milliseconds per stage of one frame on r's path (CUDA events
    between the stages, median over reps frames after one more)."""
    vp, cp = r.frame_uniforms(cam)
    rows, names = [], []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()
        names = []
        for name in frame_stages(r, vp, cp):
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
            names.append(name)
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
    med = np.median(np.array(rows[1:]), axis=0)
    return {n: float(m) for n, m in zip(names, med)}


def stage_device_ops(r: Renderer, cam) -> dict:
    """Per stage of one frame on r's path: the device operations (kernels,
    copies, memsets) torch.profiler counts and their device milliseconds.
    One profile per stage, each closed after a synchronise."""
    from torch.profiler import ProfilerActivity, profile

    vp, cp = r.frame_uniforms(cam)
    stages = frame_stages(r, vp, cp)
    out = {}
    while True:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            name = next(stages, None)
            torch.cuda.synchronize()
        if name is None:
            return out
        ops = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        out[name] = dict(ops=sum(e.count for e in ops), dev_ms=sum(e.self_device_time_total for e in ops) / 1e3)


def print_stage_ops(label: str, stages: dict, ops: dict) -> None:
    print(f"{label} per stage, device operations launched / their device ms / stage ms by events: "
          + ", ".join(f"{k} {ops[k]['ops']} / {ops[k]['dev_ms']:.3f} / {v:.3f}" for k, v in stages.items())
          + f"; sum {sum(o['ops'] for o in ops.values())} / {sum(o['dev_ms'] for o in ops.values()):.3f} / "
          f"{sum(stages.values()):.3f}")


def print_stages(label: str, stages: dict, reps: int = 5) -> None:
    print(f"{label} stage ms (frame 0, median of {reps}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + f"; sum {sum(stages.values()):.3f}")


def run_track(r: Renderer, cams) -> tuple[list, list]:
    """A warm-up frame on cams[0], then one frame per camera; returns the
    frames and their CUDA-event milliseconds."""
    r.render(cams[0])
    torch.cuda.synchronize()
    frames, times = [], []
    for cam in cams:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = r.render(cam)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
        frames.append(res)
    return frames, times


def check_frames(frames, label: str) -> None:
    for k, res in enumerate(frames):
        color, depth = res["color"], res["depth"]
        check(tuple(color.shape) == (4, HEIGHT, WIDTH) and color.dtype == torch.uint8, f"{label}: color shape")
        check(tuple(depth.shape) == (HEIGHT, WIDTH), f"{label}: depth shape")
        check(bool(torch.isfinite(depth).all()), f"{label}: non-finite depth")
        check(int(res["bin_overflow"]) == 0, f"{label} frame {k}: bin_overflow {int(res['bin_overflow'])}")
        cov = float((depth > 0).float().mean())
        check(0.05 <= cov <= 0.95, f"{label} frame {k}: coverage {cov:.3f} outside [0.05, 0.95]")


def print_times(label: str, times, r: Renderer, cam) -> None:
    """Frame times, and the device's busy time per frame of cam (kernel
    time by torch.profiler, mean of 3 frames) with the idle share it
    leaves of the median frame."""
    med = float(np.median(times))
    busy = device_ms(lambda: r.render(cam), 3)
    idle = "not measured" if busy is None else f"{1.0 - busy / med:.3f}"
    print(f"{label} frame ms: " + ", ".join(f"{t:.2f}" for t in times)
          + f" (median {med:.2f}); device busy per frame {fmt_ms(busy)} ms, idle share {idle}")


def gather_paths(scene, cams, window_frames) -> None:
    """The gather and deferred paths on the first GATHER_FRAMES cameras,
    held against the window path's frames and against each other."""
    n_rendered = GATHER_FRAMES + 1
    track = cams[:GATHER_FRAMES]
    paths = {}
    for label, change in (("gather", dict(sampler="gather")), ("deferred", dict(shading="deferred"))):
        r = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT, **change))
        texels = r.scene["atlas"]["texels"]
        torch.cuda.synchronize()
        print(f"{label} path: sampler {r.sampler}, texels {tuple(texels.shape)} {r.texture_dtype} "
              f"({texels.numel() * texels.element_size() / 1e9:.2f} GB)")
        K.reset_launches()
        frames, times = run_track(r, track)
        launches = dict(K.LAUNCHES)
        print(f"{label} path: {n_rendered} frames (1 warm-up), launches {launches}")
        print_times(label, times, r, track[0])
        want = {"raster": n_rendered, "resolve": n_rendered if label == "gather" else 0}
        for name in KERNELS:
            check(launches[name] == want.get(name, 0),
                  f"{label}: {name} launched {launches[name]} times for {n_rendered} frames, want {want.get(name, 0)}")
        check_frames(frames, label)
        print_stages(label, stage_breakdown(r, cams[0]))
        paths[label] = (r, frames)

    r_g, gather = paths["gather"]
    _, deferred = paths["deferred"]
    for k in range(GATHER_FRAMES):
        check(bool(torch.equal(gather[k]["depth"], window_frames[k]["depth"])), f"gather frame {k}: depth differs "
              "from the window path's")
    diffs = [(d["color"].int() - g["color"].int()).abs() for d, g in zip(deferred, gather)]
    d_lsb = [int(d.max()) for d in diffs]
    d_px = [int((d.amax(dim=0) > 0).sum()) for d in diffs]
    d_depth = [bool(torch.equal(d["depth"], g["depth"])) for d, g in zip(deferred, gather)]
    print(f"deferred vs gather per frame: color max LSB {d_lsb}, pixels differing {d_px}, depth equal {d_depth}")
    check(max(d_lsb) == 0 and all(d_depth), "the deferred frames differ from the forward+gather frames")
    gw = (gather[0]["color"].int() - window_frames[0]["color"].int()).abs()
    gw_px = gw.amax(dim=0)
    print(f"gather vs window, frame 0: max {int(gw.max())} LSB, pixels above 0: {int((gw_px > 0).sum())}, "
          f"above 1: {int((gw_px > 1).sum())}, above 2: {int((gw_px > 2).sum())}")
    check(int(gw.max()) <= 2, "gather frame 0 is more than 2 LSB from the window frame 0")

    sd = microbench.shade(r_g.scene["atlas"]["texels"], torch.device("cuda"))
    print(f"microbench shade on the orbit atlas {sd['atlas_shape']} {sd['atlas_dtype']} "
          f"({sd['atlas_mb']:.1f} MB), synthetic 1088x1920 G-buffer: full shade_gbuffer {sd['full_ms']:.3f} ms, "
          f"gather-only (1 row/px) {sd['gather_only_ms']:.3f} ms, trilerp-only {sd['trilerp_only_ms']:.3f} ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    path, seconds, log = _build.build()
    print(f"build: {path.name} in {seconds:.1f} s")
    for line in log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill", "error")):
            print("  nvcc:", line.strip())
    _build.library()
    for name in ("plan", "sample"):
        regs, blocks = _build.kernel_info(name)
        print(f"{name} kernel: {regs} registers per thread, {blocks} resident blocks per SM")

    t0 = time.perf_counter()
    scene = build_orbit_scene(seed=args.seed)
    cams = orbit_track(FRAMES)
    cfg = RendererConfig(width=WIDTH, height=HEIGHT)
    r = Renderer(scene, cfg)  # on the card: the default device
    torch.cuda.synchronize()
    print(f"scene: {scene.n_faces} triangles, {len(scene.texture_uris)} textures, page "
          f"{tuple(r.scene['atlas']['page'].shape)} bf16; build + upload {time.perf_counter() - t0:.1f} s")

    stats = kernel_phases(r, cams[0])
    stats.update(probe_phases(torch.device("cuda")))
    window_stages = stage_breakdown(r, cams[0])
    print_stages("window", window_stages)
    print_stage_ops("window", window_stages, stage_device_ops(r, cams[0]))

    # Window main path: a warm-up frame, then the track, with counters from zero.
    K.reset_launches()
    frames, times = run_track(r, cams)
    launches = dict(K.LAUNCHES)
    n_rendered = FRAMES + 1
    print(f"main path: {n_rendered} frames (1 warm-up), launches {launches}")
    print_times("window", times, r, cams[0])
    for name in KERNELS:
        want = n_rendered if name in RENDER_KERNELS else 0
        check(launches[name] == want, f"{name}: {launches[name]} launches for {n_rendered} frames, want {want}")
    check_frames(frames, "window")
    print("coverage per frame: " + ", ".join(f"{float((f['depth'] > 0).float().mean()):.3f}" for f in frames))
    print("window_miss_px per frame (pixels of residual tiles, sampled straight from the page): "
          + ", ".join(str(int(f["window_miss_px"])) for f in frames))

    with plain_kernels():
        plain = r.render(cams[0])
    torch.cuda.synchronize()
    lsb = int((plain["color"].int() - frames[0]["color"].int()).abs().max())
    d_eq = bool(torch.equal(plain["depth"], frames[0]["depth"]))
    miss_eq = int(plain["window_miss_px"]) == int(frames[0]["window_miss_px"])
    print(f"frame 0, kernels vs plain versions: color max LSB diff {lsb}, depth equal {d_eq}, "
          f"window_miss_px equal {miss_eq}")
    check(lsb <= 1 and d_eq and miss_eq, "full frame disagrees with the plain versions")

    # Microbenchmark path: the tools' entry points, probe counters from zero.
    K.reset_launches()
    take = microbench.vmemtake(torch.device("cuda"))
    pipe = microbench_pipeline.run(torch.device("cuda"))
    for name in PROBE_KERNELS:
        launches[name] = K.LAUNCHES[name]
        check(launches[name] > 0, f"{name}: not launched on the microbenchmark path")
    check(all(K.LAUNCHES[name] == 0 for name in RENDER_KERNELS), "a render kernel launched on the microbench path")
    print(f"microbench path: launches {dict(K.LAUNCHES)}; vmemtake {take['ms']:.4f} ms "
          f"({take['ns_per_row']:.4f} ns/row); pipeline " + json.dumps({k: round(v, 4) for k, v in pipe.items()}))

    gather_paths(scene, cams, frames)

    print("device ms per call (torch.profiler), kernel vs plain: " + "; ".join(
        f"{name} {fmt_ms(stats[name]['dev_ms'])} vs {fmt_ms(stats[name]['plain_dev_ms'])}" for name in KERNELS))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    report = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         **{k: stats[name][k] for k in keys}}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": report}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
