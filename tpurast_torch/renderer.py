"""The Renderer: render-target configuration and per-frame orchestration.

Counterpart of tpurast/renderer.py (render_frame, Renderer), same
keyword arguments and the same output dict. A frame runs

  corner transform -> triangle setup/cull -> pair binning      (torch ops)
  -> raster kernel, then one of
       forward + window: attribute pack (torch) -> resolve kernel
           -> plan kernel (texel windows per tile: the empty tiles and
              the residual pixel count) -> sample kernel (texturing from
              the page + lighting + blend)
       forward + gather: attribute pack -> resolve kernel
           -> shade_gbuffer (atlas row gathers + lighting, torch ops)
       deferred: shade-row pack -> shade_deferred (per-pixel fat-row
           gather, interpolation, atlas row gathers, lighting; torch ops)
  -> sRGB encode (torch)

eagerly on the device its tensors live on: the kernels launch on a CUDA
device and take their plain torch versions on the CPU (tpurast_torch.
kernels). The Renderer picks the sampler as the reference does: window
for forward shading when the scene has texture pages and the config
asks for "auto" or "window", the row-atlas gather otherwise.
render_frame(stage=...) runs a prefix of the frame and returns a scalar
probe of the stage's outputs (profiling.stage_sweep times the prefixes).
Scan binning and slabs (tile_row_offset, crop_height) raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tpurast_torch import math3d
from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import DeviceScene, upload
from tpurast_torch.device.textures import resolve_texture_dtype
from tpurast_torch.kernels import geometry, present, raster, resolve, sampler as ksampler, shade

log = logging.getLogger("tpurast_torch.renderer")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to tpurast_torch yet (ROADMAP queue 1 {item})")


#: The stage= prefixes of render_frame, in frame order. "segments" is the
#: reference's static segment schedule, which the port does not have.
STAGE_PREFIXES = ("geometry", "binning", "segments", "raster", "resolve", "plan", "sample")


def _stage_probe(*tensors):
    """{"stage_probe": f32 scalar}, the sum of a stage's outputs: what a
    stage= prefix frame returns in place of the framebuffer, so that a
    timed prefix runs exactly the work up to that stage and one read of
    its outputs (tpurast/renderer.py _stage_probe)."""
    s = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
    for t in tensors:
        s = s + t.to(torch.float32).sum()
    return {"stage_probe": s}


def render_frame(
    scene,
    view_proj,
    camera_position,
    *,
    width: int,
    height: int,
    tile_h: int,
    tile_w: int,
    tiles_x: int,
    tiles_y: int,
    bin_capacity: int,
    segment_headroom: int,
    clear_depth: float,
    clear_color,
    light_direction,
    light_color,
    ambient_amount: float,
    specular_power: float,
    max_anisotropy: int = 1,
    blend: str = "alpha",
    texture_format: str = "float",
    output: str = "srgb_u8",
    shading: str = "forward",
    binning: str = "scan",
    sampler: str = "gather",
    tile_row_offset=None,
    crop_height: int | None = None,
    stage: str | None = None,
):
    """One frame (tpurast/renderer.py render_frame). scene is the dict of
    tensors from tpurast_torch.device.scene.upload (with the atlas texels
    for sampler="gather" or shading="deferred", with the page for
    sampler="window"); view_proj (4, 4) and camera_position (3,) are f32
    tensors on the scene's device.

    bin_capacity and segment_headroom size the reference's scan binning
    and segment schedule, which the port does not have; they are accepted
    and unused. texture_format ("float" or "srgb8") is the texel format of
    the atlas rows the gather paths read.
    Returns {"color", "depth", "bin_overflow", "window_miss_px"}, or
    {"gbuf", "depth", "fid"} for output="gbuf" with forward shading.

    stage (one of STAGE_PREFIXES) stops the frame after that stage and
    returns {"stage_probe": the f32 sum of the stage's outputs}: geometry
    (setup, valid, aabb), binning (counts, offsets, pair_faces), raster
    (depth and face id), resolve (the G-buffer), plan (table and
    assignment), sample (the linear framebuffer). The port has no segment
    schedule, so "segments" is the binning prefix once more. "resolve"
    needs forward shading, "plan" and "sample" the window sampler: asked of
    another path they raise ValueError, as an unknown name does."""
    del bin_capacity, segment_headroom
    if binning != "pairs":
        raise _not_ported(f"binning={binning!r}", "item 14 (bin_triangles / scan)")
    if tile_row_offset is not None or crop_height is not None:
        raise _not_ported("tile_row_offset / crop_height (slabs)", "item 12")
    if stage is not None and stage not in STAGE_PREFIXES:
        raise ValueError(f"unknown stage {stage!r}: expected one of {STAGE_PREFIXES}")
    if (stage == "resolve" and shading != "forward") or (
        stage in ("plan", "sample") and (shading != "forward" or sampler != "window")
    ):
        raise ValueError(f"stage={stage!r} does not exist with shading={shading!r}, sampler={sampler!r}")
    if output not in ("srgb_u8", "linear", "gbuf"):
        raise ValueError(f"unknown output {output!r}")

    clip_c = geometry.transform_corners(scene["corner_world"], view_proj)
    setup_out = geometry.triangle_setup(clip_c, None, scene["n_faces"], width, height)
    if stage == "geometry":
        return _stage_probe(setup_out["setup"], setup_out["valid"], setup_out["aabb"])
    bins = geometry.bin_pairs(setup_out["aabb"], setup_out["valid"], tiles_x, tiles_y, tile_w, tile_h)
    if stage in ("binning", "segments"):
        return _stage_probe(bins["counts"], bins["offsets"], bins["pair_faces"])
    setup = setup_out["setup"]
    vis = raster.rasterize_tiles(
        setup, setup_out["aabb"], bins["pair_faces"], bins["offsets"], tile_h=tile_h, tile_w=tile_w,
        tiles_x=tiles_x, tiles_y=tiles_y, clear_depth=clear_depth,
    )
    if stage == "raster":
        return _stage_probe(vis)
    depth = vis[0]
    light = dict(
        light_direction=light_direction, light_color=light_color, ambient_amount=ambient_amount,
        specular_power=specular_power, clear_color=clear_color, blend=blend,
    )
    # Only the window sampler has tiles it cannot window (counted below).
    window_miss_px = torch.zeros((), dtype=torch.int32, device=depth.device)
    if shading == "forward":
        attrs = resolve.pack_resolve_attrs(
            setup, scene["corner_world"], scene["corner_normal"], scene["corner_uv"],
            scene["face_tex"], scene["atlas"],
        )
        gbuf = resolve.resolve_gbuffer(vis, attrs, max_anisotropy=max_anisotropy)
        if output == "gbuf":
            return {"gbuf": gbuf, "depth": depth, "fid": vis[1].to(torch.int32)}
        if stage == "resolve":
            return _stage_probe(gbuf)
        if sampler == "window":
            tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_h=tile_h, tile_w=tile_w)
            plan = ksampler.plan_tiles(gbuf, max_anisotropy=max_anisotropy, **tiles)
            if stage == "plan":
                return _stage_probe(plan["table"], plan["assign"])
            framebuffer = ksampler.sample_tiles(
                gbuf, scene["atlas"]["page"], plan, camera_position, max_anisotropy=max_anisotropy,
                **light, **tiles,
            )
            if stage == "sample":
                return _stage_probe(framebuffer)
            # No segment schedule, so nothing is dropped beyond the
            # binner's huge-face overflow. Every tile is sampled straight
            # from the page; the pixels of residual tiles (more windows
            # than the plan's budget) are counted as the reference counts
            # its gather fallback.
            window_miss_px = plan["residual_px"]
        else:
            framebuffer = shade.shade_gbuffer(
                gbuf, scene["atlas"]["texels"], camera_position, max_anisotropy=max_anisotropy,
                texel_format=texture_format, **light,
            )
    else:
        shade_rows = shade.pack_shade_rows(
            setup, scene["corner_world"], scene["corner_normal"], scene["corner_uv"],
            scene["face_tex"], scene["atlas"],
        )
        framebuffer = shade.shade_deferred(
            vis[1].to(torch.int32), shade_rows, scene["atlas"]["texels"], camera_position,
            max_anisotropy=max_anisotropy, texel_format=texture_format, **light,
        )
    result = {
        "depth": present.crop_linear(depth, width, height),
        "bin_overflow": bins["overflow"],
        "window_miss_px": window_miss_px,
    }
    if output == "srgb_u8":
        result["color"] = present.encode_srgb_u8(framebuffer, width, height)
    else:
        result["color"] = present.crop_linear(framebuffer, width, height)
    return result


class Renderer:
    """Owns the resident scene and the render-target configuration
    (tpurast/renderer.py Renderer). ``device`` is where the scene lives
    and every frame runs: "cuda" (the default) launches the kernels,
    "cpu" runs their plain torch versions. ``scene`` is a DeviceScene of
    either package: the fields are the same."""

    def __init__(
        self,
        scene: DeviceScene,
        config: RendererConfig | None = None,
        output: str = "srgb_u8",
        *,
        device="cuda",
    ):
        self.config = config or RendererConfig()
        cfg = self.config
        self.device = torch.device(device)
        self.scene_host = scene
        self.output = output
        if cfg.binning not in ("auto", "pairs"):
            raise _not_ported(f"binning={cfg.binning!r}", "item 14 (bin_triangles / scan)")
        self.binning = "pairs"
        # tpurast/renderer.py:440-447: the window sampler for forward
        # shading when the scene has pages, the row-atlas gather otherwise.
        if cfg.shading == "forward" and cfg.sampler in ("auto", "window") and scene.pages is not None:
            self.sampler = "window"
        else:
            self.sampler = "gather"
        self.texture_dtype = resolve_texture_dtype(scene, cfg.texture_dtype)
        # Only the gather paths read the atlas rows (shade.py).
        self.scene = upload(scene, self.device, self.texture_dtype if self.sampler == "gather" else None)
        self._configure_target(cfg.width, cfg.height)
        log.info(
            "renderer init: %dx%d | device %s | scene: %d tris, %d textures | %s shading, %s sampler, "
            "texels %s",
            cfg.width, cfg.height, self.device, scene.n_faces, len(scene.texture_uris), cfg.shading,
            self.sampler, self.texture_dtype if self.sampler == "gather" else "not uploaded",
        )

    # -- swapchain-equivalent: (re)configure render target ----------------
    def _configure_target(self, width: int, height: int) -> None:
        cfg = self.config
        self.width, self.height = width, height
        self.tiles_x = _round_up(width, cfg.tile_w) // cfg.tile_w
        self.tiles_y = _round_up(height, cfg.tile_h) // cfg.tile_h
        self.projection = math3d.perspective_inverse_depth(cfg.vfov, width / height, cfg.znear)
        self._frame_kwargs = dict(
            width=width,
            height=height,
            tile_h=cfg.tile_h,
            tile_w=cfg.tile_w,
            tiles_x=self.tiles_x,
            tiles_y=self.tiles_y,
            bin_capacity=0,
            segment_headroom=0,
            clear_depth=cfg.clear_depth,
            clear_color=cfg.clear_color,
            light_direction=cfg.light_direction,
            light_color=cfg.light_color,
            ambient_amount=cfg.ambient_amount,
            specular_power=cfg.specular_power,
            max_anisotropy=cfg.max_anisotropy,
            blend=cfg.blend,
            texture_format="srgb8" if self.texture_dtype == "srgb8" else "float",
            output=self.output,
            shading=cfg.shading,
            binning=self.binning,
            sampler=self.sampler,
        )

    def recreate_swapchain(self, width: int, height: int) -> None:
        """Resize the render target and recompute the projection
        (tpurast/renderer.py recreate_swapchain). A zero extent (minimized
        window) is ignored: rendering keeps the old target until a
        recreate with a usable extent arrives."""
        if width == 0 or height == 0:
            log.debug("swapchain recreation skipped (zero extent %dx%d)", width, height)
            return
        self._configure_target(width, height)

    # -- frame -------------------------------------------------------------
    def frame_uniforms(self, camera: Camera):
        """(view_proj (4, 4), camera position (3,)) f32 tensors on the
        renderer's device."""
        view = camera.view_matrix()
        view_proj = (self.projection @ view).astype(np.float32)
        return (
            torch.from_numpy(view_proj).to(self.device),
            torch.from_numpy(camera.position.astype(np.float32)).to(self.device),
        )

    def render(self, camera: Camera) -> dict:
        """Render one frame; returns a dict of tensors on the device."""
        return self.render_with_uniforms(*self.frame_uniforms(camera))

    def render_with_uniforms(self, view_proj, camera_position) -> dict:
        """Render one frame from precomputed frame uniforms: color, depth,
        bin_overflow, window_miss_px."""
        return render_frame(self.scene, view_proj, camera_position, **self._frame_kwargs)

    def debug_gbuf(self, camera: Camera, with_fid: bool = False):
        """Forward-path G-buffer (A_OUT, Hp, Wp), whatever the configured
        shading; with_fid=True also returns the visibility face-id image."""
        kw = dict(self._frame_kwargs, output="gbuf", shading="forward")
        out = render_frame(self.scene, *self.frame_uniforms(camera), **kw)
        return (out["gbuf"], out["fid"]) if with_fid else out["gbuf"]

    def render_to_host(self, camera: Camera) -> np.ndarray:
        """Blocking render + readback of the color buffer, interleaved to
        (H, W, 4) on the host (kernels/present.py interleave)."""
        return present.interleave(self.render(camera)["color"].cpu().numpy())
