"""Windowed-sampler stage timing: prefix (geometry..resolve) | plan | sample | full.

Counterpart of tools/profile_sampler.py. Uses the renderer's own path
(output="gbuf" for the prefix, the configured frame for full), so the
numbers are the production path's; plan and sample are timed alone on a
captured G-buffer, then the plan's tile classes, windows and probes are
summarised. Prints JSON lines as it goes, the last one with every field.
Times are the host's clock with one synchronize per group of calls. Where
the reference jits plan_tiles and sample_tiles, each is a CUDA graph on
the card (graphs.Graph, fed its own input buffers: a call copies no
input; its result is a copy of the graph's output); on the CPU and inside
kernels.plain_kernels() they run eagerly.

Run: python -m tpurast_torch.tools.profile_sampler [--scene orbit] [--max-anisotropy 16]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np

from tpurast_torch.cli import flythrough
from tpurast_torch.config import RendererConfig
from tpurast_torch.graphs import Graph, graph_wanted
from tpurast_torch.kernels import sampler as ksampler
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import _common

#: The reference's resident window slots (tpurast/kernels/sampler.py K):
#: a tile using more windows ran a second wave there.
K = 16


def time_calls(run, device, n: int = 32, group: int = 16, warmup: int = 4) -> float:
    """p50 of the per-call ms of run(i) over n calls after ``warmup``, on
    the host's clock with one synchronize per group of calls (the
    reference's time_calls; a group holds at most n calls)."""
    group = max(1, min(group, n))
    for i in range(warmup):
        run(i)
    _common.sync(device)
    times = []
    for g in range(0, n, group):
        t0 = time.perf_counter()
        for i in range(group):
            run(warmup + g + i)
        _common.sync(device)
        times.append((time.perf_counter() - t0) / group)
    return float(np.percentile(np.asarray(times) * 1e3, 50))


def compiled(fn, args, device, name: str):
    """fn over args as the reference's jax.jit of it: (call, args, the
    first result). Where graphs are wanted, call is a Graph of fn captured
    on args and the returned args are its own input buffers, so call(*args)
    replays it and copies no input; elsewhere call is fn."""
    if not graph_wanted(device):
        return fn, args, fn(*args)
    graph = Graph(fn, name=name)
    first = graph(*args)
    return graph, graph.inputs, first


def _tile_stats(plan, tile_h: int) -> dict:
    nc = tile_h // ksampler.rc_for(tile_h)
    cls = plan["cls"].cpu().numpy()
    n_used = plan["n_used"].cpu().numpy()
    # A tile's probe count: the largest of its chunks' (the reference's
    # plan_tiles "nprobe").
    nprobe = plan["table"][:, 1 : 1 + nc, ksampler.CHUNK_NP_LANE].amax(dim=1).cpu().numpy()
    win = cls == ksampler.CLS_WINDOWED
    return {
        "windowed": int(win.sum()),
        "residual": int((cls == ksampler.CLS_RESIDUAL).sum()),
        "empty": int((cls == ksampler.CLS_EMPTY).sum()),
        "n_used_mean": round(float(n_used[win].mean()), 2) if win.any() else 0,
        "n_used_p95": int(np.percentile(n_used[win], 95)) if win.any() else 0,
        "nprobe_mean": round(float(nprobe[win].mean()), 2) if win.any() else 0,
        "nprobe_p95": int(np.percentile(nprobe[win], 95)) if win.any() else 0,
        "second_wave_tiles": int((n_used[win] > K).sum()) if win.any() else 0,
    }


def profile(scene, *, scene_name: str = "orbit", width: int = 1920, height: int = 1080, frames: int = 32,
            max_anisotropy: int | None = None, device="cuda", warmup: int = 4, emit=None) -> dict:
    """The reference's fields: sampler_resolved, max_anisotropy, the ms of
    prefix(geom..resolve), plan, sample and full, and the plan's tiles;
    emit(dict) is called with each line as it is measured."""
    emit = emit or (lambda d: None)
    overrides = {"sampler": "window"}
    if max_anisotropy is not None:
        overrides["max_anisotropy"] = max_anisotropy
    cfg = RendererConfig(width=width, height=height, **overrides)
    r = Renderer(scene, cfg, device=device)
    rg = Renderer(scene, cfg, output="gbuf", device=device)
    emit({"sampler_resolved": r.sampler, "max_anisotropy": cfg.max_anisotropy})
    uniforms = [r.frame_uniforms(c) for c in flythrough(scene_name, 64)]

    def timed(run):
        return round(time_calls(run, device, frames, warmup=warmup), 2)

    out = {"prefix(geom..resolve)": timed(lambda i: rg.render_with_uniforms(*uniforms[i % 32]))}
    emit(dict(out))

    gbuf = rg.render_with_uniforms(*uniforms[8])["gbuf"]
    tiles = dict(tiles_x=r.tiles_x, tiles_y=r.tiles_y, tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    plan_fn, plan_args, plan = compiled(
        functools.partial(ksampler.plan_tiles, max_anisotropy=cfg.max_anisotropy, **tiles), (gbuf,), device, "plan")
    out["plan"] = timed(lambda i: plan_fn(*plan_args))
    emit({"plan": out["plan"]})

    light = dict(light_direction=cfg.light_direction, light_color=cfg.light_color,
                 ambient_amount=cfg.ambient_amount, specular_power=cfg.specular_power,
                 clear_color=cfg.clear_color, blend=cfg.blend)

    def sample(g, page, table, cam):  # the sampler reads the plan's table
        return ksampler.sample_tiles(g, page, {"table": table}, cam, max_anisotropy=cfg.max_anisotropy, **light,
                                     **tiles)

    sample_fn, sample_args, _ = compiled(
        sample, (gbuf, r.scene["atlas"]["page"], plan["table"], uniforms[8][1]), device, "sample")
    out["sample"] = timed(lambda i: sample_fn(*sample_args))
    emit({"sample": out["sample"]})
    for fn in (plan_fn, sample_fn):
        if isinstance(fn, Graph):
            fn.close()

    out["tiles"] = _tile_stats(plan, cfg.tile_h)
    out["full"] = timed(lambda i: r.render_with_uniforms(*uniforms[i % 32]))
    emit(dict(out))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--max-anisotropy", type=int, default=None)
    _common.add_scene_args(ap)
    args = ap.parse_args(argv)
    opened = _common.open_scene("profile_sampler", args)
    if opened is None:
        return 2
    scene, device = opened
    profile(scene, scene_name=args.scene, width=args.width, height=args.height, frames=args.frames,
            max_anisotropy=args.max_anisotropy, device=device, emit=lambda d: print(json.dumps(d), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
