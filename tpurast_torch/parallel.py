"""Slab rendering: a frame split into bands of tile rows.

Counterpart of tpurast/parallel.py (render_frame_sharded,
make_sharded_renderer). The reference shards tile rows over a mesh of
chips, one slab a chip, and joins them with the output sharding and two
psums. Here the mesh axis becomes ``n_slabs`` on one card: the slabs run
one after another on the scene's device, each through the same
renderer.render_frame as a whole frame, with tile_row_offset = its first
tile row and crop_height = its rows. Every stage evaluates at the frame's
pixel coordinates (binning floors the frame's tile rows before it offsets
them, geometry._tile_ranges; raster, resolve and deferred shading take the
row offset), so the slabs put together are the single frame bit for bit,
for both shading modes, both samplers and both binnings.

make_sharded_renderer returns the n-slab frame as one CUDA graph on a CUDA
device (graphs.FrameGraph: the reference jits it), render_frame_sharded
stays the eager function.

Tile rows are padded to a multiple of n_slabs, so the last slabs can lie
wholly below the viewport: they bin nothing but faces whose box reaches
the frame's last row (faces crossing the eye plane do), and every kernel
takes their empty or near-empty pair lists and tiles; their rows are
cropped away.
"""

from __future__ import annotations

import functools

import torch

from tpurast_torch.graphs import FrameGraph, graph_wanted
from tpurast_torch.renderer import frame_binning, frame_sampler, pair_capacity, render_frame


def render_frame_sharded(
    scene,
    view_proj,
    camera_position,
    *,
    n_slabs: int,
    width: int,
    height: int,
    tiles_y_per_slab: int,
    **frame_kwargs,
):
    """One frame as n_slabs slabs of tiles_y_per_slab tile rows each:
    color (4, height, width) and depth (height, width), the slabs' rows
    put together, and bin_overflow and window_miss_px summed over the
    slabs (the reference's psums, tpurast/parallel.py:66-67).
    frame_kwargs are render_frame's other keyword arguments, passed
    through."""
    slab_h = tiles_y_per_slab * frame_kwargs["tile_h"]
    colors, depths, overflow, window_miss = [], [], [], []
    for i in range(n_slabs):
        out = render_frame(
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
        colors.append(out["color"])
        depths.append(out["depth"])
        overflow.append(out["bin_overflow"])
        window_miss.append(out["window_miss_px"])
    # Color is channel-planar (4, H, W): slabs go together on rows.
    return {
        "color": torch.cat(colors, dim=1)[:, :height, :width],
        "depth": torch.cat(depths, dim=0)[:height, :width],
        "bin_overflow": torch.stack(overflow).sum(dtype=torch.int32),
        "window_miss_px": torch.stack(window_miss).sum(dtype=torch.int32),
    }


def make_sharded_renderer(scene_dev, config, n_slabs: int, width: int, height: int):
    """The slab frame function for config at width x height
    (tpurast/parallel.py make_sharded_renderer): fn(scene, view_proj,
    camera_position) -> the frame dict. scene_dev is the uploaded scene
    (device.scene.upload; Renderer.scene), with the atlas rows when the
    configured path reads them. Tile rows are padded to divide by n_slabs;
    the pair buffer, the binning and the sampler are chosen by the
    Renderer's own rules, the texel format from the uploaded rows, so the
    slabs run the default pipeline. On a CUDA scene (outside
    kernels.plain_kernels()) fn is a graphs.FrameGraph of that function,
    whose ``fn`` is the partial of render_frame_sharded; on the CPU, the
    partial itself."""
    if n_slabs < 1:
        raise ValueError(f"n_slabs must be >= 1, got {n_slabs}")
    tiles_x = -(-width // config.tile_w)
    tiles_y = -(-height // config.tile_h)
    tiles_y = -(-tiles_y // n_slabs) * n_slabs
    atlas = scene_dev["atlas"]
    texels = atlas.get("texels")
    fn = functools.partial(
        render_frame_sharded,
        n_slabs=n_slabs,
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
    device = scene_dev["corner_world"].device
    return FrameGraph(fn, name=f"{n_slabs}-slab frame") if graph_wanted(device) else fn
