"""Slab rendering: a frame split into bands of tile rows over a mesh of devices.

Counterpart of tpurast/parallel.py (render_frame_sharded,
make_sharded_renderer) and of __graft_entry__.py::dryrun_multichip
(dryrun). The reference shards tile rows over a 1-D mesh of chips, one
slab a chip, with the scene replicated (in_specs=P()), and joins the slabs
with its output sharding (rows) and two psums (bin_overflow,
window_miss_px). Here the mesh is a list of torch devices, one slab an
entry, driven from one host thread: the single-controller form of
shard_map, as the reference's is; no torch.distributed.

  * Each distinct device of the list gets one replica of the uploaded
    scene (device.scene.replicate; the scene's own device keeps the scene),
    made once when the frame function is made.
  * A device's slabs run concurrently, as devices of a mesh do: on a CUDA
    device each slab renders on a stream of its own, forked from the
    current stream and joined back to it (render_slabs). On a CUDA device
    (outside kernels.plain_kernels()) that function is one CUDA graph per
    device (graphs.FrameGraph: the reference jits the frame); the graph
    keeps the fork and the join, so the slabs' branches run side by side
    on replay. On the CPU the slabs run one after another.
  * The join: the slabs' color (4, rows, W) and depth rows are copied to
    devices[0] in slab order and cropped to height x width, bin_overflow
    and window_miss_px summed there as int32 0-dim tensors. Nothing is
    read back to the host. With one device (an int n is n entries of the
    scene's device) the join is part of that device's graph: one replay a
    frame.

Every slab is the same renderer.render_frame as a whole frame, with
tile_row_offset = its first tile row and crop_height = its rows, and
every stage evaluates at the frame's pixel coordinates (binning floors
the frame's tile rows before it offsets them, geometry._tile_ranges;
raster, resolve and deferred shading take the row offset), so the slabs
put together are the single frame bit for bit, for both shading modes,
both samplers and both binnings, on any device list.

Tile rows are padded to a multiple of the device count, so the last slabs
can lie wholly below the viewport: they bin nothing but faces whose box
reaches the frame's last row (faces crossing the eye plane do), and every
kernel takes their empty or near-empty pair lists and tiles; their rows
are cropped away.

Run: python -m tpurast_torch.parallel --devices N [--repeat] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import torch

from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import orbit_track, replicate, scene_bytes
from tpurast_torch.device.scene_cache import load_named_scene
from tpurast_torch.graphs import FrameGraph, graph_wanted
from tpurast_torch.renderer import Renderer, check_tiles, frame_binning, frame_sampler, pair_capacity, render_frame


def render_slabs(scene, view_proj, camera_position, *, slabs, width: int, height: int, tiles_y_per_slab: int,
                 **frame_kwargs) -> dict:
    """The slabs numbered ``slabs`` of a frame cut into slabs of
    tiles_y_per_slab tile rows, on the scene's device: color
    (4, k * slab_h, width) and depth (k * slab_h, width), the slabs' rows
    in the order of ``slabs``, bin_overflow and window_miss_px summed over
    them (0-dim int32). On a CUDA device each slab renders on a stream of
    its own, forked from the current stream and joined back (_fork_join).
    frame_kwargs are render_frame's other keyword arguments, passed
    through."""
    slab_h = tiles_y_per_slab * frame_kwargs["tile_h"]

    def slab(i):
        return render_frame(
            scene,
            view_proj,
            camera_position,
            width=width,
            height=height,  # the frame's viewport: the frame's clip, cull and AABBs
            tiles_y=tiles_y_per_slab,
            tile_row_offset=i * tiles_y_per_slab,
            crop_height=slab_h,
            **frame_kwargs,
        )

    outs = _fork_join([functools.partial(slab, i) for i in slabs], scene["corner_world"].device)
    # Color is channel-planar (4, H, W): slabs go together on rows.
    return {
        "color": torch.cat([o["color"] for o in outs], dim=1),
        "depth": torch.cat([o["depth"] for o in outs], dim=0),
        "bin_overflow": torch.stack([o["bin_overflow"] for o in outs]).sum(dtype=torch.int32),
        "window_miss_px": torch.stack([o["window_miss_px"] for o in outs]).sum(dtype=torch.int32),
    }


def _fork_join(calls, device) -> list:
    """[call() for call in calls], on a CUDA device each call on a stream
    of its own, forked from the device's current stream and joined back to
    it (under a capture the graph keeps the fork and the join); on the CPU
    one after another."""
    if device.type != "cuda":
        return [call() for call in calls]
    current = torch.cuda.current_stream(device)
    streams, outs = [], []
    for call in calls:
        stream = torch.cuda.Stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            outs.append(call())
        streams.append(stream)
    for stream in streams:
        current.wait_stream(stream)
    # The outputs are read on the current stream from here on: their memory
    # must not return to a call's stream before that.
    for out in outs:
        for v in out.values():
            v.record_stream(current)
    return outs


def _crop(frame: dict, width: int, height: int) -> dict:
    """The frame dict with color and depth cropped to height x width."""
    return dict(frame, color=frame["color"][:, :height, :width], depth=frame["depth"][:height, :width])


def render_frame_sharded(scene, view_proj, camera_position, *, n_slabs: int, width: int, height: int,
                         tiles_y_per_slab: int, **frame_kwargs) -> dict:
    """One frame as n_slabs slabs on the scene's device (render_slabs):
    color (4, height, width) and depth (height, width), the slabs' rows
    put together, and bin_overflow and window_miss_px summed over the
    slabs (the reference's psums, tpurast/parallel.py:66-67)."""
    out = render_slabs(scene, view_proj, camera_position, slabs=range(n_slabs), width=width, height=height,
                       tiles_y_per_slab=tiles_y_per_slab, **frame_kwargs)
    return _crop(out, width, height)


def _device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d


class MeshFrame:
    """The slab frame over several devices: fn(scene, view_proj,
    camera_position) -> the frame dict on devices[0] (module docstring).
    ``replicas`` holds the scene on each distinct device (the scene itself
    on its own device), ``fns`` each device's slab function (a FrameGraph
    where graphs are wanted) and ``slots`` each slab's device and place
    among that device's slabs. view_proj and camera_position may lie on
    any device."""

    def __init__(self, scene_dev: dict, devices, frame_kwargs: dict):
        self.scene = scene_dev
        self.devices = [_device(d) for d in devices]
        self.width, self.height = frame_kwargs["width"], frame_kwargs["height"]
        self.slab_h = frame_kwargs["tiles_y_per_slab"] * frame_kwargs["tile_h"]
        groups: dict[torch.device, list[int]] = {}
        for i, d in enumerate(self.devices):
            groups.setdefault(d, []).append(i)
        home = scene_dev["corner_world"].device
        self.replicas = {d: scene_dev if d == home else replicate(scene_dev, d) for d in groups}
        self.fns = {}
        for d, slabs in groups.items():
            fn = functools.partial(render_slabs, slabs=tuple(slabs), **frame_kwargs)
            self.fns[d] = FrameGraph(fn, name=f"slabs {slabs} on {d}") if graph_wanted(d) else fn
        self.slots = [(d, groups[d].index(i)) for i, d in enumerate(self.devices)]

    def __call__(self, scene, view_proj, camera_position) -> dict:
        if scene is not self.scene:
            raise ValueError("MeshFrame: the scene differs from the one replicated when the function was made")
        # Every device's uniforms first, then every device's slabs: a copy
        # between cards orders the streams of both, and one queued after a
        # device's slabs would hold the next device back until they end.
        uniforms = {d: (view_proj.to(d, non_blocking=True), camera_position.to(d, non_blocking=True))
                    for d in self.fns}
        parts = {d: fn(self.replicas[d], *uniforms[d]) for d, fn in self.fns.items()}
        home = self.devices[0]
        moved = {d: {k: v.to(home, non_blocking=True) for k, v in p.items()} for d, p in parts.items()}
        rows = [(moved[d], slice(j * self.slab_h, (j + 1) * self.slab_h)) for d, j in self.slots]
        frame = {
            "color": torch.cat([p["color"][:, r] for p, r in rows], dim=1),
            "depth": torch.cat([p["depth"][r] for p, r in rows], dim=0),
            "bin_overflow": torch.stack([p["bin_overflow"] for p in moved.values()]).sum(dtype=torch.int32),
            "window_miss_px": torch.stack([p["window_miss_px"] for p in moved.values()]).sum(dtype=torch.int32),
        }
        return _crop(frame, self.width, self.height)


def make_sharded_renderer(scene_dev, config, devices, width: int, height: int):
    """The slab frame function for config at width x height
    (tpurast/parallel.py make_sharded_renderer): fn(scene, view_proj,
    camera_position) -> the frame dict on devices[0]. ``devices`` is the
    mesh, a sequence of torch devices, one slab each; an int n stands for
    n entries of the scene's device. scene_dev is the uploaded scene
    (device.scene.upload; Renderer.scene), with the atlas rows when the
    configured path reads them. Tile rows are padded to divide by the
    device count; the pair buffer, the binning and the sampler are chosen
    by the Renderer's own rules, the texel format from the uploaded rows,
    so the slabs run the default pipeline.

    Where every entry is the scene's device, fn is the partial of
    render_frame_sharded, or on a CUDA device (outside
    kernels.plain_kernels()) a graphs.FrameGraph of it, whose ``fn`` is
    that partial. Otherwise fn is a MeshFrame over the devices."""
    check_tiles(config.tile_h, config.tile_w)
    home = scene_dev["corner_world"].device
    devices = [home] * devices if isinstance(devices, int) else [_device(d) for d in devices]
    n_slabs = len(devices)
    if n_slabs < 1:
        raise ValueError(f"n_slabs must be >= 1, got {n_slabs}")
    tiles_x = -(-width // config.tile_w)
    tiles_y = -(-height // config.tile_h)
    tiles_y = -(-tiles_y // n_slabs) * n_slabs
    atlas = scene_dev["atlas"]
    texels = atlas.get("texels")
    kw = dict(
        width=width,
        height=height,
        tiles_y_per_slab=tiles_y // n_slabs,
        tile_h=config.tile_h,
        tile_w=config.tile_w,
        tiles_x=tiles_x,
        bin_capacity=pair_capacity(config, int(scene_dev["corner_world"].shape[0])),
        segment_headroom=0,  # the port has no segment schedule
        clear_depth=config.clear_depth,
        clear_color=config.clear_color,
        light_direction=config.light_direction,
        light_color=config.light_color,
        ambient_amount=config.ambient_amount,
        specular_power=config.specular_power,
        max_anisotropy=config.max_anisotropy,
        blend=config.blend,
        # The texel format of the uploaded atlas rows (srgb8 rows are u8);
        # the window path uploads none and reads the page.
        texture_format="srgb8" if texels is not None and texels.dtype == torch.uint8 else "float",
        shading=config.shading,
        binning=frame_binning(config),
        sampler=frame_sampler(config, "page" in atlas),
    )
    if any(d != home for d in devices):
        return MeshFrame(scene_dev, devices, kw)
    fn = functools.partial(render_frame_sharded, n_slabs=n_slabs, **kw)
    return FrameGraph(fn, name=f"{n_slabs}-slab frame") if graph_wanted(home) else fn


def frame_graphs(fn) -> list[FrameGraph]:
    """The CUDA graphs behind a make_sharded_renderer function (none on
    the CPU)."""
    fns = fn.fns.values() if isinstance(fn, MeshFrame) else [fn]
    return [g for g in fns if isinstance(g, FrameGraph)]


def _card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(device.index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def dryrun(n_devices: int, device="cuda", repeat: bool = False, *, width: int = 1920, height: int = 1080,
           frames: int = 10) -> dict:
    """The slab frame over an n-device mesh against the single frame
    (__graft_entry__.py::dryrun_multichip): the orbit scene (seed 0) at
    width x height, camera 0 of orbit_track. device "cuda": one slab on
    each of cuda:0..n-1 (raises where fewer cards exist), or with
    ``repeat`` n slabs on cuda:0; "cpu": n slabs on the CPU. The frame
    function's first call renders eagerly and captures its graphs, its
    second replays them: both must equal the Renderer's frame bit for bit
    (color, depth, both counters). Returns the JSON line: the devices, the
    slab rows, equal or not, the median ms of ``frames`` sharded and single
    frames (host clock around each, ended by a synchronize of every device
    of the mesh; graph replays on the card), capture ms and pool bytes of
    the graphs, the bytes of each device's scene replica (0 on the scene's
    own device) and, on the card, its name and power limit."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun: no CUDA device (torch.cuda.is_available() is false); pass device='cpu'")
        count = torch.cuda.device_count()
        if not repeat and count < n_devices:
            raise RuntimeError(f"dryrun: {n_devices} devices asked, {count} CUDA devices present; "
                               f"repeat=True (--repeat) runs {n_devices} slabs on cuda:0")
        devices = [torch.device("cuda", 0 if repeat else i) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices

    scene = load_named_scene("orbit", seed=0)
    cfg = RendererConfig(width=width, height=height)
    r = Renderer(scene, cfg, device=devices[0])
    uniforms = r.frame_uniforms(orbit_track(8)[0])
    fn = make_sharded_renderer(r.scene, cfg, devices, width, height)
    mesh = sorted(set(devices), key=str)

    def sync():
        for d in mesh:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def median_ms(call):
        times = []
        for _ in range(frames):
            t0 = time.perf_counter()
            call()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    single = r.render_with_uniforms(*uniforms)
    first = fn(r.scene, *uniforms)
    again = fn(r.scene, *uniforms)
    sync()
    keys = ("color", "depth", "bin_overflow", "window_miss_px")
    equal = all(torch.equal(f[k], single[k]) and f[k].device == single[k].device for f in (first, again)
                for k in keys)
    single_ms = median_ms(lambda: r.render_with_uniforms(*uniforms))
    sharded_ms = median_ms(lambda: fn(r.scene, *uniforms))
    graphs = frame_graphs(fn)
    replicas = fn.replicas if isinstance(fn, MeshFrame) else {devices[0]: r.scene}
    return {
        "devices": [str(d) for d in devices],
        "slab_rows": -(-(-(-height // cfg.tile_h)) // n_devices) * cfg.tile_h,
        "equal": equal,
        "sharded_ms": round(sharded_ms, 4),
        "single_ms": round(single_ms, 4),
        "ratio": round(sharded_ms / single_ms, 4),
        "graphs": len(graphs),
        "capture_ms": [round(g.capture_ms, 1) for g in graphs],
        "pool_bytes": [g.pool_bytes for g in graphs],
        "replica_bytes": {str(d): 0 if s is r.scene else scene_bytes(s) for d, s in replicas.items()},
        "card": [_card(d) for d in mesh] if dev.type == "cuda" else "cpu",
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="The slab frame over a mesh of devices against the single frame.")
    ap.add_argument("--devices", type=int, required=True, help="slabs, one per device: cuda:0..N-1")
    ap.add_argument("--repeat", action="store_true", help="run the N slabs on cuda:0")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    out = dryrun(args.devices, device=args.device, repeat=args.repeat)
    print(json.dumps(out))
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
