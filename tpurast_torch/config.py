"""Renderer configuration.

The reference hardcodes every tunable (SURVEY.md §5 "Config / flag system"):
window 1280x720 (src/Engine.zig:56), vfov 80 deg / znear 0.01
(src/Renderer.zig:468-474), move speed 2.0 (src/Camera.zig:73), mouse
sensitivity 0.002 (src/Camera.zig:103), light constants
(shaders/src/basic.frag:15-17), clear color magenta (src/Renderer.zig:1008).
We expose them as a dataclass whose defaults reproduce the reference values.
"""

from __future__ import annotations

import dataclasses
import math


def _normalize3(v: tuple[float, float, float]) -> tuple[float, float, float]:
    n = math.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return (v[0] / n, v[1] / n, v[2] / n)


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    # Render target (reference: 1280x720 window, src/Engine.zig:56).
    width: int = 1280
    height: int = 720

    # Projection (src/Renderer.zig:468-475): vfov 80 deg, znear 0.01,
    # infinite far plane with reversed-Z.
    vfov_deg: float = 80.0
    znear: float = 0.01

    # Clear values (src/Renderer.zig:1008, :1014): magenta color, depth 0.0
    # (reversed-Z "far").
    clear_color: tuple[float, float, float, float] = (1.0, 0.0, 1.0, 1.0)
    clear_depth: float = 0.0

    # Directional light (shaders/src/basic.frag:15-17).
    light_color: tuple[float, float, float] = (0.86, 0.65, 0.35)
    light_direction: tuple[float, float, float] = _normalize3((1.0, -1.0, 1.0))
    ambient_amount: float = 0.1
    specular_power: float = 32.0

    # Camera (src/Camera.zig:73, :103-105).
    move_speed: float = 2.0
    mouse_sensitivity: float = 0.002
    pitch_limit: float = 0.5 * math.pi - 0.01

    # --- TPU pipeline tunables (no reference analog; the GPU rasterizer's
    # fixed-function tiling made these implicit). ---
    # Framebuffer tile size: one Pallas program rasterizes one tile.
    # tile_w must be a multiple of 128 (tiles are written directly as
    # (C, tile_h, tile_w) framebuffer rectangles, lane dim = tile_w) and
    # tile_h a multiple of 8 (row-group granularity). 32x128 keeps the
    # same 4096 px/tile as round-1's 64x64 with full lane occupancy.
    tile_h: int = 32
    tile_w: int = 128
    # Binned-pair buffer capacity (static shape): total (tile, face)
    # pairs per frame for the scan binning path. None = auto (4x the
    # padded face count — generous; typical scenes emit < 2 pairs/face).
    # Truncation is counted in the frame's bin_overflow.
    bin_capacity: int | None = None
    # Extra raster work segments beyond one-per-tile (covers tiles whose
    # bins exceed 128 triangles). Each segment is a (tile, 128-triangle
    # chunk) grid step; see kernels/raster.py.
    segment_headroom: int = 8192

    # Binning algorithm: "auto" picks per target size — the chunked
    # rank-by-cumsum scan is O(tiles x faces) but sort-free (wins for
    # ordinary scenes); "pairs" emits (tile, face) pairs and 2-key-sorts
    # them (O(pairs log pairs), wins for 4K instanced scenes where
    # tiles x faces explodes). See kernels/geometry.py.
    binning: str = "auto"

    # Atlas texel dtype. "auto" (default): float16 normally — exact for
    # BC6H sources, <1 u8 LSB for BC7 — switching to "srgb8" (u8 rows,
    # sRGB-encoded RGB + linear alpha: EXACTLY the BC source precision,
    # 4x smaller) when the f16 atlas would exceed ~2 GB and content is
    # LDR, because v5e gather throughput degrades sharply with table
    # footprint. "float32" is bit-exact to the f32 sampling reference;
    # "float16"/"bfloat16"/"srgb8" select explicitly.
    texture_dtype: str = "auto"

    # Texture sampling anisotropy: ratio-clamped probes along the
    # major-axis gradient, implemented in both shading paths
    # (kernels/shade.aniso_footprint) and the windowed sampler
    # (kernels/sampler.py, per-tile dynamic probe counts). Default 16
    # matches the reference sampler, which always requests
    # maxAnisotropy 16 (src/Renderer.zig:515).
    max_anisotropy: int = 16
    # Framebuffer blend state (src/Renderer.zig:447-458): "alpha" is the
    # reference's srcAlpha/oneMinusSrcAlpha+add color blend with zero/one
    # alpha blend; "opaque" bypasses the blend equation.
    blend: str = "alpha"

    # Shading path: "forward" interpolates attributes per pixel inside the
    # Pallas resolve kernel (kernels/resolve.py; fastest); "deferred" is
    # the per-pixel fat-gather path (same output, kept for verification).
    shading: str = "forward"

    # Texture sampling engine (forward shading only): "window" samples
    # through per-tile VMEM texel windows + MXU one-hot selection
    # (kernels/sampler.py — footprint-independent, the porsche-class
    # fix); "gather" is the per-pixel atlas row gather. "auto" picks
    # window when the scene has texture pages, with gather as the
    # per-tile fallback for unwindowable tiles either way.
    sampler: str = "auto"

    @property
    def vfov(self) -> float:
        return math.radians(self.vfov_deg)

    @property
    def aspect(self) -> float:
        return self.width / self.height


DEFAULT_CONFIG = RendererConfig()
