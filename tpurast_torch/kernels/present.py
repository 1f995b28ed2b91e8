"""Present stage as torch ops: linear -> sRGB u8 encode and crops.

Counterpart of tpurast/kernels/present.py, same names. Planes stay
channel-planar (4, H, W); ``interleave`` (a copy of
tpurast/present.py interleave) makes (H, W, 4) on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def encode_srgb_u8(planes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(4, Hp, Wp) linear f32 -> (4, height, width) sRGB u8, cropping tile
    padding. Alpha is linear (pass-through)."""
    fb = planes[:, :height, :width]
    rgb = linear_to_srgb(fb[:3])
    a = torch.clamp(fb[3:4], 0.0, 1.0)
    out = torch.cat([rgb, a], dim=0)
    return torch.round(out * 255.0).to(torch.uint8)


def crop_linear(framebuffer: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(..., Hp, Wp) -> (..., height, width)."""
    return framebuffer[..., :height, :width]


def interleave(img: np.ndarray) -> np.ndarray:
    """(4, H, W) channel-planar (the device framebuffer layout; a
    channel-minor device array would pad 4 -> 128 lanes) -> (H, W, 4)
    interleaved host image. The host-side half of the swapchain's
    surface-format conversion."""
    if img.ndim == 3 and img.shape[0] == 4:
        return np.ascontiguousarray(np.moveaxis(img, 0, -1))
    return img
