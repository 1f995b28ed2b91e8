"""Frame-stats overlay (tpurast/overlay.py, as it is).

The reference draws a semi-transparent "Frametime: X ms" box pinned
top-left. Headless equivalent: the overlay is composited onto the
presented host image (PIL bitmap font, imported when an overlay is drawn
and only then), and the "settings" surface is the RendererConfig / engine
API.
"""

from __future__ import annotations

import numpy as np


def draw_frametime_overlay(frame: np.ndarray, frametime_ms: float) -> np.ndarray:
    """Composite the stats box onto an (H, W, 3|4) u8 frame (copy)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(frame)
    draw = ImageDraw.Draw(img, "RGBA")
    text = f"Frametime: {frametime_ms:8.5f} ms"
    x, y = 8, 8
    tw = draw.textlength(text)
    # Semi-transparent dark box like the reference's overlay (bg alpha 0.35).
    draw.rectangle([x - 4, y - 4, x + tw + 4, y + 14], fill=(20, 20, 30, 90))
    draw.text((x, y), text, fill=(230, 230, 235, 255))
    return np.asarray(img)


class FrameStats:
    """Rolling frame-time statistics: per-frame wall-clock deltas, with
    percentiles for the bench."""

    def __init__(self, window: int = 240) -> None:
        self.window = window
        self.samples_ms: list[float] = []

    def record(self, seconds: float) -> None:
        self.samples_ms.append(seconds * 1e3)
        if len(self.samples_ms) > self.window:
            self.samples_ms.pop(0)

    @property
    def last_ms(self) -> float:
        return self.samples_ms[-1] if self.samples_ms else 0.0

    def percentile(self, p: float) -> float:
        if not self.samples_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.samples_ms), p))

    @property
    def p50_ms(self) -> float:
        return self.percentile(50)

    @property
    def fps(self) -> float:
        p50 = self.p50_ms
        return 1000.0 / p50 if p50 > 0 else 0.0
