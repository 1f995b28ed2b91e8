#!/usr/bin/env python3
"""Smoke run of the tpurast_torch main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from tpurast_torch/csrc, builds a procedural scene
from the seed (a 256x256-quad floor and 64 UV spheres, 258,048 triangles,
eight generated 1024^2 BC4 textures with full mip chains), and then, at
1920x1080:

  1. runs one frame's real inputs through each kernel (raster, resolve,
     plan, sample) and through its plain torch version on the same
     device, and holds the two against each other: raster depth and face
     id exact; resolve integer planes exact, float planes within rtol
     1e-5 / atol 1e-6 outside pixels whose mip level l0 flipped (at most
     0.1% of covered pixels); plan table and assignment exact; sample
     within 1 LSB after the sRGB u8 encode, and its frame with every
     tile forced to direct page reads equal to the staged one;
  2. renders a warm-up frame plus 8 frames of an orbiting camera through
     tpurast_torch.renderer.Renderer, checks that every kernel's launch
     counter rose by one per frame, that nothing overflowed and that
     5-95% of the pixels are covered;
  3. renders frame 0 again with every kernel's plain version and compares
     the frames: color within 1 LSB, depth exact.

Any failure raises. The last stdout line is {"ok": true, "device": ...};
the line before it lists each kernel's launches, error and times.
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

from tpurast.config import RendererConfig  # noqa: E402
from tpurast_torch import kernels as K  # noqa: E402
from tpurast_torch.device.scene import build_orbit_scene, orbit_track  # noqa: E402
from tpurast_torch.kernels import _build, geometry, present, raster, resolve, sampler, shade  # noqa: E402
from tpurast_torch.renderer import Renderer  # noqa: E402

KERNELS = {
    "raster": ("tpurast_torch/csrc/raster.cu", "tpurast/kernels/raster.py:88"),
    "resolve": ("tpurast_torch/csrc/resolve.cu", "tpurast/kernels/resolve.py:126"),
    "plan": ("tpurast_torch/csrc/plan.cu", "tpurast/kernels/sampler.py:230"),
    "sample": ("tpurast_torch/csrc/sampler.cu", "tpurast/kernels/sampler.py:650"),
}
FRAMES = 8
WIDTH, HEIGHT = 1920, 1080
FLOAT_PLANES = [i for i in range(resolve.A_OUT) if i not in resolve.INT_PLANES]


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


@contextlib.contextmanager
def plain_kernels():
    """Route render_frame's kernel calls to their plain torch versions."""
    saved = (raster.rasterize_tiles, resolve.resolve_gbuffer, sampler.plan_tiles, sampler.sample_tiles)
    raster.rasterize_tiles = raster.rasterize_tiles_plain
    resolve.resolve_gbuffer = resolve.resolve_gbuffer_plain
    sampler.plan_tiles = sampler.plan_tiles_plain
    sampler.sample_tiles = sampler.sample_tiles_plain
    try:
        yield
    finally:
        raster.rasterize_tiles, resolve.resolve_gbuffer, sampler.plan_tiles, sampler.sample_tiles = saved


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

    vis = raster.rasterize_tiles(so["setup"], bins["pair_faces"], bins["offsets"], **rkw)
    vis_p = raster.rasterize_tiles_plain(so["setup"], bins["pair_faces"], bins["offsets"], **rkw)
    torch.cuda.synchronize()
    fid_bad = int((vis[1] != vis_p[1]).sum())
    depth_bad = int((vis[0] != vis_p[0]).sum())
    depth_err = float((vis[0] - vis_p[0]).abs().max())
    covered = int((vis[1] >= 0).sum())
    out["raster"] = dict(
        max_abs_err=depth_err,
        ms=cuda_ms(lambda: raster.rasterize_tiles(so["setup"], bins["pair_faces"], bins["offsets"], **rkw), 20),
        plain_ms=cuda_ms(lambda: raster.rasterize_tiles_plain(so["setup"], bins["pair_faces"], bins["offsets"], **rkw), 2),
    )
    counts = bins["counts"].float()
    print(f"raster: pairs {int(bins['offsets'][-1])} (per tile mean {float(counts.mean()):.0f}, "
          f"max {int(counts.max())}), covered px {covered}; vs plain: face id differs at {fid_bad} px, "
          f"depth at {depth_bad} px, max abs diff {depth_err}; "
          f"{out['raster']['ms']:.3f} ms vs plain {out['raster']['plain_ms']:.3f} ms")
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
    out["resolve"] = dict(
        max_abs_err=res_err,
        ms=cuda_ms(lambda: resolve.resolve_gbuffer(vis, attrs, max_anisotropy=ma), 20),
        plain_ms=cuda_ms(lambda: resolve.resolve_gbuffer_plain(vis, attrs, max_anisotropy=ma), 3),
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
    out["plan"] = dict(
        max_abs_err=float((plan["assign"] - plan_p["assign"]).abs().max()),
        ms=cuda_ms(lambda: sampler.plan_tiles(g, max_anisotropy=ma, **tiles), 20),
        plain_ms=cuda_ms(lambda: sampler.plan_tiles_plain(g, max_anisotropy=ma, **tiles), 3),
    )
    cls = plan["cls"]
    n_used = plan["n_used"][cls == sampler.CLS_WINDOWED].float()
    print(f"plan: tiles windowed {int((cls == sampler.CLS_WINDOWED).sum())}, residual "
          f"{int((cls == sampler.CLS_RESIDUAL).sum())} ({int(plan['residual_px'])} px), empty "
          f"{int((cls == sampler.CLS_EMPTY).sum())}; windows per windowed tile mean {float(n_used.mean()):.2f} "
          f"max {int(n_used.max())}; vs plain: table words differing {table_bad}, assignments differing "
          f"{assign_bad}; {out['plan']['ms']:.3f} ms vs plain {out['plan']['plain_ms']:.3f} ms")
    check(table_bad == 0 and assign_bad == 0, "plan kernel disagrees with its plain version")

    skw = dict(
        max_anisotropy=ma, light_direction=kw["light_direction"], light_color=kw["light_color"],
        ambient_amount=kw["ambient_amount"], specular_power=kw["specular_power"],
        clear_color=kw["clear_color"], blend=kw["blend"], **tiles,
    )
    page = sc["atlas"]["page"]
    fb = sampler.sample_tiles(g, page, plan, cp, **skw)
    fb_p = sampler.sample_tiles_plain(g, page, plan, cp, **skw)
    w, h = kw["width"], kw["height"]
    enc_diff = (present.encode_srgb_u8(fb, w, h).int() - present.encode_srgb_u8(fb_p, w, h).int()).abs()
    lsb = int(enc_diff.max())
    px_bad = int((enc_diff.amax(dim=0) > 0).sum())
    smp_err = float((fb - fb_p).abs().max())
    out["sample"] = dict(
        max_abs_err=smp_err,
        ms=cuda_ms(lambda: sampler.sample_tiles(g, page, plan, cp, **skw), 20),
        plain_ms=cuda_ms(lambda: sampler.sample_tiles_plain(g, page, plan, cp, **skw), 3),
    )
    n_probe = shade.probe_count(g[17], g[14], g[15], g[9], g[10], ma)[g[16] > 0]
    print(f"sample: probes per covered px mean {float(n_probe.mean()):.2f} max {float(n_probe.max()):.0f}, "
          f"mip levels in view {sorted(int(x) for x in torch.unique(g[19][g[16] > 0]).tolist())}; "
          f"vs plain: {px_bad} px differ after the u8 encode, max {lsb} LSB, linear max abs diff {smp_err}; "
          f"{out['sample']['ms']:.3f} ms vs plain {out['sample']['plain_ms']:.3f} ms")
    check(lsb <= 1, "sample kernel disagrees with its plain version")

    # Residual tiles read every texel straight from the page. The same
    # plan with every windowed tile marked residual must give the same
    # frame bit for bit: staging only changes where a texel is read from.
    table = plan["table"].clone()
    table[:, 0, 0] = torch.where(table[:, 0, 0] == sampler.CLS_WINDOWED, sampler.CLS_RESIDUAL, table[:, 0, 0])
    forced = dict(plan, table=table)
    fb_r = sampler.sample_tiles(g, page, forced, cp, **skw)
    same = bool(torch.equal(fb_r, fb))
    direct_ms = cuda_ms(lambda: sampler.sample_tiles(g, page, forced, cp, **skw), 20)
    print(f"sample, every covered tile forced residual (direct page reads): frame equal to the windowed one "
          f"{same}; {direct_ms:.3f} ms vs windowed {out['sample']['ms']:.3f} ms")
    check(same, "residual-tile sampling disagrees with windowed sampling")
    return out


def stage_breakdown(r: Renderer, cam, reps: int = 5) -> dict:
    """Milliseconds per stage of one frame on the main path (CUDA events
    between the stages, median over reps frames)."""
    kw = r._frame_kwargs
    sc = r.scene
    vp, cp = r.frame_uniforms(cam)
    names = ["geometry", "binning", "raster", "pack_attrs", "resolve", "plan", "sample", "encode"]
    tiles = dict(tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=kw["tile_h"], tile_w=kw["tile_w"])
    rows = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        clip = geometry.transform_corners(sc["corner_world"], vp)
        so = geometry.triangle_setup(clip, None, sc["n_faces"], kw["width"], kw["height"])
        ev[1].record()
        bins = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"])
        ev[2].record()
        vis = raster.rasterize_tiles(
            so["setup"], bins["pair_faces"], bins["offsets"], tile_h=kw["tile_h"], tile_w=kw["tile_w"],
            tiles_x=r.tiles_x, tiles_y=r.tiles_y, clear_depth=kw["clear_depth"],
        )
        ev[3].record()
        attrs = resolve.pack_resolve_attrs(
            so["setup"], sc["corner_world"], sc["corner_normal"], sc["corner_uv"], sc["face_tex"], sc["atlas"]
        )
        ev[4].record()
        g = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=kw["max_anisotropy"])
        ev[5].record()
        plan = sampler.plan_tiles(g, max_anisotropy=kw["max_anisotropy"], **tiles)
        ev[6].record()
        fb = sampler.sample_tiles(
            g, sc["atlas"]["page"], plan, cp, max_anisotropy=kw["max_anisotropy"],
            light_direction=kw["light_direction"], light_color=kw["light_color"],
            ambient_amount=kw["ambient_amount"], specular_power=kw["specular_power"],
            clear_color=kw["clear_color"], blend=kw["blend"], **tiles,
        )
        ev[7].record()
        present.encode_srgb_u8(fb, kw["width"], kw["height"])
        ev[8].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
    med = np.median(np.array(rows[1:]), axis=0)
    return {n: float(m) for n, m in zip(names, med)}


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

    t0 = time.perf_counter()
    scene = build_orbit_scene(seed=args.seed)
    cams = orbit_track(FRAMES)
    cfg = RendererConfig(width=WIDTH, height=HEIGHT)
    r = Renderer(scene, cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"scene: {scene.n_faces} triangles, {len(scene.texture_uris)} textures, page "
          f"{tuple(r.scene['atlas']['page'].shape)} bf16; build + upload {time.perf_counter() - t0:.1f} s")

    stats = kernel_phases(r, cams[0])
    stages = stage_breakdown(r, cams[0])
    print("stage ms (frame 0, median of 5): " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.3f}")

    # Main path: a warm-up frame, then the track, with counters from zero.
    K.reset_launches()
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
    launches = dict(K.LAUNCHES)
    n_rendered = FRAMES + 1
    print(f"main path: {n_rendered} frames (1 warm-up), launches {launches}")
    print("frame ms: " + ", ".join(f"{t:.2f}" for t in times) + f" (median {float(np.median(times)):.2f})")
    for name in KERNELS:
        check(launches[name] == n_rendered, f"{name}: {launches[name]} launches for {n_rendered} frames")
    for k, res in enumerate(frames):
        color, depth = res["color"], res["depth"]
        check(tuple(color.shape) == (4, HEIGHT, WIDTH) and color.dtype == torch.uint8, "color shape")
        check(tuple(depth.shape) == (HEIGHT, WIDTH), "depth shape")
        check(bool(torch.isfinite(depth).all()), "non-finite depth")
        check(int(res["bin_overflow"]) == 0, f"frame {k}: bin_overflow {int(res['bin_overflow'])}")
        cov = float((depth > 0).float().mean())
        check(0.05 <= cov <= 0.95, f"frame {k}: coverage {cov:.3f} outside [0.05, 0.95]")
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

    report = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name], **stats[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": report}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
