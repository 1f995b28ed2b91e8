"""Present stage: linear -> sRGB u8 encode and crops.

Counterpart of tpurast/kernels/present.py, same names. The reference leaves
the encode to XLA. For CUDA tensors the port runs it as one CUDA kernel
(encode_srgb_u8: csrc/encode.cu, ``LAUNCHES["encode"]``); the torch code of
encode_srgb_u8_plain is its plain version, which CPU tensors and
kernels.plain_kernels() take. Planes stay channel-planar (4, H, W);
``interleave`` (a copy of tpurast/present.py interleave) makes (H, W, 4) on
the host.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurast_torch import kernels as _k
from tpurast_torch.kernels import _build


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def encode_srgb_u8_plain(planes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """encode_srgb_u8 as torch ops."""
    fb = planes[:, :height, :width]
    rgb = linear_to_srgb(fb[:3])
    a = torch.clamp(fb[3:4], 0.0, 1.0)
    out = torch.cat([rgb, a], dim=0)
    return torch.round(out * 255.0).to(torch.uint8)


def _encode_kernel(planes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """encode_srgb_u8 on the card (csrc/encode.cu tr_encode): one launch
    reads the crop of the contiguous (4, Hp, Wp) f32 planes and writes the
    (4, height, width) u8 frame."""
    _k.check(planes, "planes", torch.float32)
    if planes.dim() != 3 or planes.shape[0] != 4:
        raise ValueError(f"planes: expected (4, Hp, Wp), got {tuple(planes.shape)}")
    _, hp, wp = planes.shape
    if not (0 <= width <= wp and 0 <= height <= hp):
        raise ValueError(f"a {width}x{height} crop does not fit planes of {wp}x{hp}")
    out = torch.empty((4, height, width), dtype=torch.uint8, device=planes.device)
    _build.call("tr_encode", planes, hp, wp, int(width), int(height), out)
    _k.LAUNCHES["encode"] += 1
    return out


def encode_srgb_u8(planes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(4, Hp, Wp) linear f32 -> (4, height, width) sRGB u8, cropping tile
    padding. Alpha is linear (pass-through). CUDA tensors take the encode
    kernel (csrc/encode.cu) in one launch, the same bits; CPU tensors and
    plain_kernels() encode_srgb_u8_plain."""
    if _k.use_kernel(planes):
        return _encode_kernel(planes, width, height)
    return encode_srgb_u8_plain(planes, width, height)


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
