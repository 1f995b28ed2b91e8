"""The Renderer: render-target configuration and per-frame orchestration.

Counterpart of tpurast/renderer.py (render_frame, Renderer), same
keyword arguments and the same output dict. A frame runs

  corner transform + triangle setup/cull (setup kernel) -> pair binning (bin kernels)
  -> raster kernel, then one of
       forward + window: resolve kernel
           -> plan kernel (texel windows per tile: the empty tiles and
              the residual pixel count) -> sample kernel (texturing from
              the page + lighting + blend)
       forward + gather: resolve kernel
           -> gather kernel (shade_gbuffer: each pixel's own probes from
              the atlas rows + lighting + blend)
       deferred: deferred kernel
           (shade_deferred: the pixel's face row, interpolation, its own
           probes from the atlas rows, lighting, blend)
  -> sRGB encode (encode kernel)

The resolve and deferred kernels read each pixel's face row from the
frame's setup rows and the scene's per-face table (scene["resolve_table"],
scene["shade_table"]), which the upload builds once
(device/scene.py face_tables): no frame packs a per-face table.

on the device its tensors live on: the kernels launch on a CUDA device and
take their plain torch versions on the CPU (tpurast_torch.kernels).
render_frame runs eagerly. The Renderer runs it on a CUDA device as a
CUDA graph per (render target, output), captured on first use and
replayed after (tpurast_torch.graphs; the reference's jax.jit of the
frame function), and eagerly on the CPU and inside kernels.plain_kernels().
The Renderer picks the sampler as the reference does: window
for forward shading when the scene has texture pages and the config
asks for "auto" or "window", the row-atlas gather otherwise.
render_frame(stage=...) runs a prefix of the frame and returns a scalar
probe of the stage's outputs (profiling.stage_sweep times the prefixes).
binning="scan" bins with geometry.bin_triangles (draw order in a buffer
of bin_capacity pairs) where "pairs" takes geometry.bin_pairs; the two
give the same frame. render_frame(tile_row_offset=, crop_height=) renders
a slab of tile rows in the frame's pixel coordinates (parallel.py puts
slabs together into the same frame, bit for bit). render_frame(marks=)
places the frame's seven stage marks (tracing.py); every Renderer but a
G-buffer one (output="gbuf") gives its frame graph its device's marks and
records a ``frame`` span around each frame it renders.
"""

from __future__ import annotations

import functools
import logging

import numpy as np
import torch

from tpurast_torch import math3d, tracing
from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import DeviceScene, face_tables, upload
from tpurast_torch.device.textures import resolve_texture_dtype
from tpurast_torch.graphs import FrameGraph, graph_wanted
from tpurast_torch.kernels import geometry, present, raster, resolve, sampler as ksampler, shade

log = logging.getLogger("tpurast_torch.renderer")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def check_tiles(tile_h: int, tile_w: int) -> None:
    """Raise ValueError where the reference refuses a tile shape, naming
    the rule: tile_w a multiple of the 128-lane width
    (tpurast/kernels/raster.py:359), tile_h a multiple of 8
    (kernels/sampler.py rc_for) and at most 7 chunks of rc_for(tile_h) rows
    (the plan table's rows, sampler.py:471). The reference takes tile_h in
    {8, 16, ..., 64, 80, 96, 112} with any multiple of 128 as tile_w; so
    does the port, on the CPU and on the card."""
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile {tile_h}x{tile_w}: tile_h and tile_w must be positive")
    if tile_w % 128 != 0:
        raise ValueError(f"tile {tile_h}x{tile_w}: tile_w must be a multiple of the lane width 128")
    if tile_h % 8 != 0:
        raise ValueError(f"tile {tile_h}x{tile_w}: tile_h must be a multiple of 8")
    rc = ksampler.rc_for(tile_h)
    if tile_h // rc > 7:
        raise ValueError(f"tile {tile_h}x{tile_w}: tile_h must be at most 7 chunks of {rc} rows "
                         f"(the plan table's rows), got {tile_h // rc}")


def frame_binning(cfg: RendererConfig) -> str:
    """The binner of cfg.binning: "auto" is the pair sort
    (tpurast/renderer.py:456-464)."""
    if cfg.binning not in ("auto", "pairs", "scan"):
        raise ValueError(f"unknown binning {cfg.binning!r}")
    return "pairs" if cfg.binning == "auto" else cfg.binning


def frame_sampler(cfg: RendererConfig, has_pages: bool) -> str:
    """The window sampler for forward shading when the scene has texture
    pages and cfg asks for "auto" or "window", the row-atlas gather
    otherwise (tpurast/renderer.py:440-447)."""
    return "window" if cfg.shading == "forward" and cfg.sampler in ("auto", "window") and has_pages else "gather"


def pair_capacity(cfg: RendererConfig, n_faces_padded: int) -> int:
    """The scan binner's pair buffer (tpurast/renderer.py:465-473): 4 pairs
    a face, at least 16384, unless cfg.bin_capacity says otherwise; a
    multiple of 128. Pairs past it are counted in bin_overflow."""
    cap = max(4 * n_faces_padded, 16384) if cfg.bin_capacity is None else cfg.bin_capacity
    return _round_up(max(cap, 128), 128)


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


def _no_mark(i, overflow=None, miss=None) -> None:
    pass


def _no_stamps(start=None, end=None) -> tuple:
    return None, None


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
    marks: tracing.FrameMarks | None = None,
):
    """One frame (tpurast/renderer.py render_frame). scene is the dict of
    tensors from tpurast_torch.device.scene.upload (with the atlas texels
    for sampler="gather" or shading="deferred", with the page for
    sampler="window"; with scene["resolve_table"] for forward shading,
    scene["shade_table"] for deferred: device/scene.py face_tables);
    view_proj (4, 4) and camera_position (3,) are f32
    tensors on the scene's device.

    binning="pairs" bins with geometry.bin_pairs, any other value (the
    reference's rule) with geometry.bin_triangles into bin_capacity pair
    slots, both ranging a face cut by the eye plane by its near-plane box
    (geometry.near_boxes) where the reference gives it the whole screen:
    the same frame, fewer pairs; segment_headroom sizes the reference's segment schedule,
    which the port does not have, and is accepted and unused.
    texture_format ("float" or "srgb8") is the texel format of the atlas
    rows the gather paths read.

    A slab: tile_row_offset is its first tile row in the frame, tiles_y
    its tile rows and crop_height (default height) the rows it returns;
    width and height stay the frame's, and every stage evaluates at the
    frame's pixel coordinates. Take tile_row_offset as a Python int: a
    0-dim tensor is accepted and read with int(), one synchronize.
    Returns {"color", "depth", "bin_overflow", "window_miss_px"}, or
    {"gbuf", "depth", "fid"} for output="gbuf" with forward shading.

    stage (one of STAGE_PREFIXES) stops the frame after that stage and
    returns {"stage_probe": the f32 sum of the stage's outputs}: geometry
    (setup, valid, aabb), binning (counts, offsets, pair_faces), raster
    (depth and face id), resolve (the G-buffer), plan (table and
    assignment), sample (the linear framebuffer). The port has no segment
    schedule, so "segments" is the binning prefix once more. "resolve"
    needs forward shading, "plan" and "sample" the window sampler: asked of
    another path they raise ValueError, as an unknown name does.

    marks (a tracing.FrameMarks, or None for none) receives tracing.MARKS:
    the frame's start and the end of geometry, binning, raster, the pack,
    shading and the encode, the last with bin_overflow, window_miss_px and
    the binner's cut_faces and huge_faces;
    on the kernel path raster and the first and last shading kernels stamp
    the four marks between (FrameMarks.stamps). A whole frame only: not
    with stage= or output="gbuf"."""
    del segment_headroom
    check_tiles(tile_h, tile_w)
    ty_base = 0 if tile_row_offset is None else int(tile_row_offset)
    out_h = height if crop_height is None else crop_height
    if stage is not None and stage not in STAGE_PREFIXES:
        raise ValueError(f"unknown stage {stage!r}: expected one of {STAGE_PREFIXES}")
    if (stage == "resolve" and shading != "forward") or (
        stage in ("plan", "sample") and (shading != "forward" or sampler != "window")
    ):
        raise ValueError(f"stage={stage!r} does not exist with shading={shading!r}, sampler={sampler!r}")
    if output not in ("srgb_u8", "linear", "gbuf"):
        raise ValueError(f"unknown output {output!r}")
    if marks is not None and (stage is not None or output == "gbuf"):
        raise ValueError("marks= needs a whole frame: no stage= prefix, no gbuf output")
    mark = _no_mark if marks is None else marks.mark
    stamps = _no_stamps if marks is None else marks.stamps

    mark(0)
    clip_c, setup_out = geometry.setup_faces(scene["corner_world"], view_proj, scene["n_faces"], width, height)
    if stage == "geometry":
        return _stage_probe(setup_out["setup"], setup_out["valid"], setup_out["aabb"])
    mark(1)
    grid = (setup_out["aabb"], setup_out["valid"], tiles_x, tiles_y, tile_w, tile_h)
    # Faces cut by the eye plane take the tiles of their near-plane boxes.
    near = (clip_c, width, height)
    if binning == "pairs":
        bins = geometry.bin_pairs(*grid, ty_base=ty_base, near=near)
    else:
        bins = geometry.bin_triangles(*grid, bin_capacity, ty_base=ty_base, near=near)
    if stage in ("binning", "segments"):
        return _stage_probe(bins["counts"], bins["offsets"], bins["pair_faces"])
    mark(2)
    setup = setup_out["setup"]
    vis = raster.rasterize_tiles(
        setup, setup_out["aabb"], bins["pair_faces"], bins["offsets"], tile_h=tile_h, tile_w=tile_w,
        tiles_x=tiles_x, tiles_y=tiles_y, clear_depth=clear_depth, tile_row_offset=ty_base, stamps=stamps(2, 3),
    )
    if stage == "raster":
        return _stage_probe(vis)
    mark(3)
    depth = vis[0]
    light = dict(
        light_direction=light_direction, light_color=light_color, ambient_amount=ambient_amount,
        specular_power=specular_power, clear_color=clear_color, blend=blend,
    )
    # Only the window sampler has tiles it cannot window (counted below).
    window_miss_px = torch.zeros((), dtype=torch.int32, device=depth.device)
    if shading == "forward":
        mark(4)
        gbuf = resolve.resolve_gbuffer(vis, setup, scene["resolve_table"], max_anisotropy=max_anisotropy,
                                       tile_row_offset=ty_base, tile_h=tile_h, stamps=stamps(4))
        if output == "gbuf":
            return {"gbuf": gbuf, "depth": depth, "fid": vis[1].to(torch.int32)}
        if stage == "resolve":
            return _stage_probe(gbuf)
        if sampler == "window":
            # The plan and the sample read pixel rows only to index the
            # slab's own G-buffer and tiles: no frame row offset.
            tiles = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_h=tile_h, tile_w=tile_w)
            plan = ksampler.plan_tiles(gbuf, max_anisotropy=max_anisotropy, **tiles)
            if stage == "plan":
                return _stage_probe(plan["table"], plan["assign"])
            framebuffer = ksampler.sample_tiles(
                gbuf, scene["atlas"]["page"], plan, camera_position, max_anisotropy=max_anisotropy,
                stamps=stamps(None, 5), **light, **tiles,
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
                texel_format=texture_format, srgb_lut=scene["atlas"].get("srgb_lut"), stamps=stamps(None, 5),
                **light,
            )
    else:
        mark(4)
        framebuffer = shade.shade_deferred(
            vis[1], setup, scene["shade_table"], scene["atlas"]["texels"], camera_position,
            max_anisotropy=max_anisotropy, y_offset=ty_base * tile_h, texel_format=texture_format,
            srgb_lut=scene["atlas"].get("srgb_lut"), stamps=stamps(4, 5), **light,
        )
    mark(5)
    result = {
        "depth": present.crop_linear(depth, width, out_h),
        "bin_overflow": bins["overflow"],
        "window_miss_px": window_miss_px,
    }
    if output == "srgb_u8":
        result["color"] = present.encode_srgb_u8(framebuffer, width, out_h)
    else:
        result["color"] = present.crop_linear(framebuffer, width, out_h)
    if marks is not None:
        marks.faces(bins["cut_faces"], bins["huge_faces"])
    mark(6, bins["overflow"], window_miss_px)
    return result


class _PinnedUniforms:
    """A frame's view_proj (4, 4) and camera position (3,) to the card
    through a ring of pinned host buffers, one copy a frame into a new
    device tensor of 19 floats. A copy from pageable memory would wait for
    the stream, and so for the frame before. A buffer is written again only
    once the event recorded after its last copy has passed, which waits
    only when the host runs SLOTS frames ahead of the card."""

    SLOTS = 8

    def __init__(self, device: torch.device):
        self.device = device
        self.host = [torch.empty(19, dtype=torch.float32, pin_memory=True) for _ in range(self.SLOTS)]
        self.arrays = [h.numpy() for h in self.host]
        # An event not yet recorded passes synchronize() at once.
        self.copied = [torch.cuda.Event() for _ in range(self.SLOTS)]
        self.turn = 0

    def __call__(self, view_proj: np.ndarray, position: np.ndarray):
        i = self.turn
        self.turn = (i + 1) % self.SLOTS
        self.copied[i].synchronize()
        self.arrays[i][:16] = view_proj.reshape(-1)
        self.arrays[i][16:] = position
        dev = self.host[i].to(self.device, non_blocking=True)
        self.copied[i].record(torch.cuda.current_stream(self.device))
        return dev[:16].view(4, 4), dev[16:]


class Renderer:
    """Owns the resident scene and the render-target configuration
    (tpurast/renderer.py Renderer). ``device`` is where the scene lives
    and every frame runs: "cuda" (the default) launches the kernels,
    "cpu" runs their plain torch versions. ``scene`` is a DeviceScene of
    either package: the fields are the same.

    On a CUDA device render, render_with_uniforms and debug_gbuf replay a
    CUDA graph of render_frame (graphs.FrameGraph), one per output, captured
    at their first call for the current target; recreate_swapchain drops
    them. On the CPU and inside kernels.plain_kernels() they call
    render_frame (uses_graphs).

    The target's frame function ("frame") gives render_frame the device's
    tracing.FrameMarks (``marks``), and render and render_with_uniforms
    record each frame's ``frame`` span; the first frame calibrates the
    device's clock. A Renderer of output="gbuf" has no frame to mark: it
    renders with neither (``marks`` is None)."""

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
        check_tiles(cfg.tile_h, cfg.tile_w)
        self.device = torch.device(device)
        self.scene_host = scene
        self.output = output
        self.binning = frame_binning(cfg)
        self.sampler = frame_sampler(cfg, scene.pages is not None)
        self.texture_dtype = resolve_texture_dtype(scene, cfg.texture_dtype)
        self._graphs: dict[str, FrameGraph] = {}
        self._uniforms = _PinnedUniforms(self.device) if self.device.type == "cuda" else None
        # A frame of output "gbuf" stops at the G-buffer: no frame to mark.
        self.marks = None if output == "gbuf" else tracing.marks(self.device)
        self._calibrated = False
        # Only the gather paths read the atlas rows (shade.py); the frame
        # reads the face table of its shading.
        self.scene = upload(scene, self.device, self.texture_dtype if self.sampler == "gather" else None,
                            tables=("shade",) if cfg.shading == "deferred" else ("resolve",))
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
        for graph in self._graphs.values():
            graph.close()
        self._graphs = {}
        self.width, self.height = width, height
        self.tiles_x = _round_up(width, cfg.tile_w) // cfg.tile_w
        self.tiles_y = _round_up(height, cfg.tile_h) // cfg.tile_h
        self.bin_capacity = pair_capacity(cfg, int(self.scene_host.faces.shape[0]))
        self.projection = math3d.perspective_inverse_depth(cfg.vfov, width / height, cfg.znear)
        self._frame_kwargs = dict(
            width=width,
            height=height,
            tile_h=cfg.tile_h,
            tile_w=cfg.tile_w,
            tiles_x=self.tiles_x,
            tiles_y=self.tiles_y,
            bin_capacity=self.bin_capacity,
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
    @property
    def uses_graphs(self) -> bool:
        """True where frames replay CUDA graphs: on a CUDA device, outside
        kernels.plain_kernels()."""
        return graph_wanted(self.device)

    def _frame_fn(self, key: str, **change):
        """fn(scene, view_proj, camera_position) for render_frame with the
        target's arguments and ``change`` (and for "frame" the Renderer's
        marks): the target's graph ``key`` (made on first use) where
        uses_graphs, render_frame itself elsewhere."""
        kw = dict(self._frame_kwargs, **change)
        if key == "frame" and self.marks is not None:
            kw["marks"] = self.marks
        if not self.uses_graphs:
            return functools.partial(render_frame, **kw)
        if key not in self._graphs:
            name = f"{key} graph at {self.width}x{self.height}"
            self._graphs[key] = FrameGraph(functools.partial(render_frame, **kw), name=name)
        return self._graphs[key]

    def graph_info(self) -> dict:
        """{key: {"capture_ms", "pool_bytes", "launches"}} of the target's
        captured graphs ("frame", "gbuf")."""
        return {
            k: dict(capture_ms=g.capture_ms, pool_bytes=g.pool_bytes, launches=dict(g.launches))
            for k, g in self._graphs.items()
        }

    def frame_uniforms(self, camera: Camera):
        """(view_proj (4, 4), camera position (3,)) f32 tensors on the
        renderer's device; on a CUDA device copied from pinned memory,
        without waiting for the stream."""
        view = camera.view_matrix()
        view_proj = (self.projection @ view).astype(np.float32)
        position = camera.position.astype(np.float32)
        if self._uniforms is not None:
            return self._uniforms(view_proj, position)
        return torch.from_numpy(view_proj), torch.from_numpy(position)

    def render(self, camera: Camera) -> dict:
        """Render one frame; returns a dict of tensors on the device."""
        return self.render_with_uniforms(*self.frame_uniforms(camera))

    def render_with_uniforms(self, view_proj, camera_position) -> dict:
        """Render one frame from precomputed frame uniforms: color, depth,
        bin_overflow, window_miss_px."""
        fn = self._frame_fn("frame")
        if self.marks is None:  # a G-buffer Renderer
            return fn(self.scene, view_proj, camera_position)
        span = tracing.FRAME.begin()
        try:
            out = fn(self.scene, view_proj, camera_position)
        finally:
            tracing.FRAME.end(span)
        if not self._calibrated:
            self.marks.calibrate()
            self._calibrated = True
        return out

    def debug_gbuf(self, camera: Camera, with_fid: bool = False):
        """Forward-path G-buffer (A_OUT, Hp, Wp), whatever the configured
        shading; with_fid=True also returns the visibility face-id image.
        A deferred Renderer builds the resolve table at its first call."""
        face_tables(self.scene, ("resolve",))
        fn = self._frame_fn("gbuf", output="gbuf", shading="forward")
        out = fn(self.scene, *self.frame_uniforms(camera))
        return (out["gbuf"], out["fid"]) if with_fid else out["gbuf"]

    def render_to_host(self, camera: Camera) -> np.ndarray:
        """Blocking render + readback of the color buffer, interleaved to
        (H, W, 4) on the host (kernels/present.py interleave)."""
        return present.interleave(self.render(camera)["color"].cpu().numpy())
