"""The quad-row texture atlas on the device, and the texel dtype rule.

``upload_atlas`` is the port's counterpart of TextureAtlas.device
(tpurast/device/textures.py:55-138): the (N, 52) trilerp rows of
``atlas.texels`` as a row-major contiguous torch tensor in one of the
reference's four texel dtypes, plus the offsets, sizes and mip counts.

  float32   the host rows as they are;
  float16   rounded by torch (round to nearest even, as numpy's astype);
  bfloat16  rounded by torch (bit for bit what ml_dtypes gives, tested);
  srgb8     u8 rows: RGB sRGB-encoded, alpha linear, by the reference's
            exact decision-boundary searchsorted; LDR content only.

The reference pins a TPU layout on the texel table (:109-132); a torch
tensor is row-major already, so nothing here corresponds to that.
``resolve_texture_dtype`` is Renderer._resolve_texture_dtype
(tpurast/renderer.py:420-432), kept as the reference states it.
"""

from __future__ import annotations

import numpy as np
import torch

TEXTURE_DTYPES = ("float32", "float16", "bfloat16", "srgb8")
_TORCH_FLOAT = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}
# texture_dtype="auto" switches to srgb8 above this f16 atlas size.
SRGB8_ABOVE_F16_BYTES = 2 << 30


def srgb8_encode(texels: np.ndarray) -> np.ndarray:
    """(N, 52) f32 linear rows -> (N, 52) u8: RGB lanes sRGB-encoded,
    alpha lanes linear (textures.py:79-103). u8 value k is chosen iff
    x >= EOTF((k - 0.5) / 255), so one searchsorted against the 255
    boundaries gives the exact encode."""
    if texels.size and texels.max() > 1.0 + 1e-6:
        raise ValueError("srgb8 atlas requires LDR content (texel values in [0, 1])")
    mid = (np.arange(1, 256, dtype=np.float64) - 0.5) / 255.0
    bounds_srgb = np.where(mid <= 0.04045, mid / 12.92, ((mid + 0.055) / 1.055) ** 2.4).astype(np.float32)
    bounds_lin = ((np.arange(1, 256) - 0.5) / 255.0).astype(np.float32)
    texels4 = texels.reshape(texels.shape[0], -1, 4)
    enc = np.empty(texels4.shape, dtype=np.uint8)
    enc[..., :3] = np.searchsorted(bounds_srgb, np.clip(texels4[..., :3], 0.0, 1.0))
    enc[..., 3] = np.searchsorted(bounds_lin, np.clip(texels4[..., 3], 0.0, 1.0))
    return enc.reshape(texels.shape)


def texels_tensor(texels: np.ndarray, dtype: str) -> torch.Tensor:
    """The host rows as a CPU tensor of the texel dtype."""
    if dtype == "srgb8":
        return torch.from_numpy(srgb8_encode(texels))
    if dtype not in _TORCH_FLOAT:
        raise ValueError(f"unknown texture dtype {dtype!r}; expected one of {TEXTURE_DTYPES}")
    return torch.from_numpy(np.ascontiguousarray(texels, dtype=np.float32)).to(_TORCH_FLOAT[dtype])


def upload_atlas(atlas, dtype: str, device) -> dict:
    """TextureAtlas.device(dtype) as torch tensors on ``device``:
    {"texels" (N, 52), "offsets" (T, 16), "sizes" (T, 16, 2), "n_mips" (T,)}."""
    dev = torch.device(device)
    return {
        "texels": texels_tensor(atlas.texels, dtype).contiguous().to(dev),
        "offsets": torch.from_numpy(np.array(atlas.offsets)).to(dev),
        "sizes": torch.from_numpy(np.array(atlas.sizes)).to(dev),
        "n_mips": torch.from_numpy(np.array(atlas.n_mips)).to(dev),
    }


def resolve_texture_dtype(scene, requested: str) -> str:
    """texture_dtype="auto": float16, or srgb8 when the f16 atlas would
    exceed 2 GiB and the content is LDR (tpurast/renderer.py:420-432;
    the threshold was set for the TPU's gather and has not been measured
    on the H100). Any other value is returned as it is."""
    if requested != "auto":
        return requested
    f16_bytes = scene.atlas.texels.nbytes // 2
    if f16_bytes > SRGB8_ABOVE_F16_BYTES and scene.atlas.max_value() <= 1.0 + 1e-6:
        return "srgb8"
    return "float16"
