"""Texture mip atlas: host-side build, the upload, and the texel dtype rule.

The host part is a copy of tpurast/device/textures.py without
TextureAtlas.device() (jax, ml_dtypes): all scene textures, decoded from
KTX2/BC on the host (tpurast_torch.assets), become one flat (N, 52) f32
table of linear-color trilerp rows with per-(texture, mip) offsets and
sizes. sRGB texels are EOTF-decoded to linear before filtering; alpha
(the specular mask) is linear and untouched.

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

import concurrent.futures
import dataclasses
import os

import numpy as np
import torch

from tpurast_torch.assets import bcdec, ktx2

MAX_MIPS = 16


ROW_WIDTH = 52  # 2x2 own-mip quad (16) + 3x3 parent-mip window (36)


class _RowsOnFirstRead:
    """TextureAtlas.texels: the quad rows, built from the atlas' pyramids
    (a _RowPlan) the first time something reads them, then kept. Only the
    gather paths read rows; the window path uploads none, so a scene built
    for it never holds them (208 B of host RAM per texel)."""

    def __set_name__(self, owner, name):
        self.slot = "_" + name

    def __get__(self, atlas, owner=None):
        if atlas is None:
            raise AttributeError(self.slot)  # the dataclass field has no default
        rows = atlas.__dict__[self.slot]
        if isinstance(rows, _RowPlan):
            rows = atlas.__dict__[self.slot] = rows.build()
        return rows

    def __set__(self, atlas, rows):
        atlas.__dict__[self.slot] = rows


@dataclasses.dataclass
class _RowPlan:
    """Where build_atlas puts each (texture, mip)'s rows: enough to build
    the rows, and to count them, without holding them."""

    pyramids: list[list[np.ndarray]]
    allocs: list[tuple[int, int, int]]  # (texture, mip, first row)
    n_rows: int

    def build(self) -> np.ndarray:
        rows = np.zeros((max(self.n_rows, 1), ROW_WIDTH), dtype=np.float32)

        def fill(alloc):
            ti, mi, off = alloc
            mips = self.pyramids[ti]
            h, w = mips[mi].shape[:2]
            parent = mips[mi + 1] if mi + 1 < len(mips) else None
            _trilerp_rows(mips[mi], parent, out=rows[off : off + h * w])

        # Each (texture, mip) fills its own rows, and numpy's copies release
        # the GIL: threads fill them side by side, the largest first.
        order = sorted(self.allocs, key=lambda a: -self.pyramids[a[0]][a[1]].size)
        with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            list(pool.map(fill, order))
        return rows

    def max_value(self) -> float:
        # Every texel of every mip sits in the rows, beside zeros (the
        # alignment padding and the last mips' parent windows).
        return float(np.max([0.0] + [m.max() for mips in self.pyramids for m in mips if m.size]))


@dataclasses.dataclass
class TextureAtlas:
    """Host-side staging of the atlas; upload_atlas uploads it with torch.

    Texels are stored as "trilerp rows": entry (x, y) of mip l holds the
    whole 2x2 bilinear footprint [(x,y), (x+1,y), (x,y+1), (x+1,y+1)]
    (neighbors wrapped for repeat addressing, 16 floats) PLUS the 3x3
    window of mip l+1 anchored at ((x-1)//2, (y-1)//2) (36 floats) — the
    parent bilinear footprint for ANY sample point that maps to quad
    (x, y) lands inside that window (offset 0 or 1 on each axis, derived
    per pixel in kernels/shade.py). One gather per TRILINEAR sample
    instead of eight point fetches: XLA:TPU gather cost is per row and
    dominated by address generation, so row width is nearly free while
    row count is the wall (~7 ns/row on v5e).

    build_atlas leaves the rows unbuilt: ``texels`` builds them on first
    read (bit for bit the rows build_atlas once concatenated), while
    ``texels_nbytes`` and ``max_value`` answer from the pyramids.
    """

    texels: np.ndarray = _RowsOnFirstRead()  # (N, 52) f32 linear RGBA trilerp rows
    offsets: np.ndarray  # (T, MAX_MIPS) i32 flat row offset per mip (256-aligned)
    sizes: np.ndarray  # (T, MAX_MIPS, 2) i32 (width, height) per mip
    n_mips: np.ndarray  # (T,) i32

    @property
    def rows_built(self) -> bool:
        """Whether the quad rows are held (read once, or given)."""
        return not isinstance(self.__dict__["_texels"], _RowPlan)

    @property
    def texels_nbytes(self) -> int:
        """The f32 rows' bytes, without building them."""
        rows = self.__dict__["_texels"]
        return max(rows.n_rows, 1) * ROW_WIDTH * 4 if isinstance(rows, _RowPlan) else rows.nbytes

    def max_value(self) -> float:
        rows = self.__dict__["_texels"]
        if isinstance(rows, _RowPlan):
            return rows.max_value()
        return float(rows.max()) if rows.size else 0.0


def _to_linear_rgba(img: np.ndarray, srgb: bool) -> np.ndarray:
    """uint8/float image (H, W, C in {1,3,4}) -> (H, W, 4) f32 linear."""
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    out = np.empty((h, w, 4), dtype=np.float32)
    if img.dtype == np.uint8:
        if srgb:
            out[..., :3] = bcdec.srgb_to_linear(img[..., : min(c, 3)])
        else:
            out[..., :3] = img[..., : min(c, 3)].astype(np.float32) / 255.0
        if c == 1:
            out[..., 1] = out[..., 2] = out[..., 0]
        out[..., 3] = img[..., 3].astype(np.float32) / 255.0 if c == 4 else 1.0
    else:
        out[..., :3] = img[..., : min(c, 3)].astype(np.float32)
        if c == 1:
            out[..., 1] = out[..., 2] = out[..., 0]
        out[..., 3] = img[..., 3].astype(np.float32) if c == 4 else 1.0
    return out


def mip_chain(base: np.ndarray) -> list[np.ndarray]:
    """Box-filter mip chain for procedurally generated textures.
    (KTX2 assets ship their own mips; this is for fallback/synthetic.)"""
    mips = [base]
    m = base
    while m.shape[0] > 1 or m.shape[1] > 1:
        h = max(1, m.shape[0] // 2)
        w = max(1, m.shape[1] // 2)
        m2 = m[: h * 2, : w * 2].reshape(h, 2, w, 2, -1).mean(axis=(1, 3))
        mips.append(m2.astype(np.float32))
        m = m2
    return mips


def fallback_texture(data_dir=None) -> list[np.ndarray]:
    """The reference's embedded fallback texture: 64x64 BC7-sRGB
    black/magenta checkerboard (2x2-texel cells, BLACK at the origin),
    alpha 128 (half-specular mask), 7 shipped mips
    (resources/textures.zig:1, bound at src/Renderer.zig:551-566).

    Decoded from the real resources/textures/missing_diffuse_specular_
    bc7.ktx2 next to the data dir (the analog of the reference's
    @embedFile); falls back to an equivalent procedural pattern when the
    resources tree isn't mounted. tests/test_assets.py pins the decode
    against the procedural reconstruction."""
    if data_dir is not None:
        import os

        path = os.path.join(
            os.path.dirname(os.path.abspath(os.fspath(data_dir))),
            "resources",
            "textures",
            "missing_diffuse_specular_bc7.ktx2",
        )
        if os.path.exists(path):
            return decode_ktx2_texture(ktx2.load_ktx2(path))
    y, x = np.mgrid[0:64, 0:64]
    checker = ((x // 2 + y // 2) % 2 == 1).astype(np.float32)  # black at (0,0)
    base = np.zeros((64, 64, 4), dtype=np.float32)
    base[..., 0] = checker  # magenta squares (sRGB 255 -> linear 1.0)
    base[..., 2] = checker
    base[..., 3] = 128.0 / 255.0  # uniform half-specular mask
    return mip_chain(base)


def decode_ktx2_texture(tex: ktx2.Ktx2Texture) -> list[np.ndarray]:
    """Decode every mip level of a KTX2 texture to linear f32 RGBA."""
    mips = []
    for lvl in tex.levels:
        img = bcdec.decode_level(lvl.data, tex.format_name, lvl.width, lvl.height)
        mips.append(_to_linear_rgba(img, tex.is_srgb))
    return mips


def _trilerp_rows(m: np.ndarray, parent: np.ndarray | None, out: np.ndarray | None = None) -> np.ndarray:
    """(H, W, 4) + parent mip -> (H*W, 52) trilerp rows.

    Columns 0:16 are the own-mip quad (2x2 wrapped bilinear footprint);
    16:52 the parent 3x3 window (row-major texel order, 4 channels each)
    anchored at ((x-1)//2 mod w1, (y-1)//2 mod h1). For the last mip
    (parent None) the window is zero — the sampler's mip fraction is
    exactly 0 there. Writes straight into one preallocated row buffer
    (the concat-of-concats formulation re-copied every chunk and
    dominated multi-GB atlas builds): ``out`` (H*W, 52) where given.
    """
    h, w = m.shape[:2]
    m = np.ascontiguousarray(m, dtype=np.float32)
    if out is None:
        out = np.empty((h * w, ROW_WIDTH), dtype=np.float32)
    own = out[:, :16].reshape(h, w, 4, 4)
    own[..., 0, :] = m
    right = np.roll(m, -1, axis=1)
    own[..., 1, :] = right
    own[..., 2, :] = np.roll(m, -1, axis=0)
    own[..., 3, :] = np.roll(right, -1, axis=0)
    if parent is None:
        out[:, 16:] = 0.0
        return out
    h1, w1 = parent.shape[:2]
    parent = np.ascontiguousarray(parent, dtype=np.float32)
    bx = (np.arange(w) - 1) // 2 % w1  # (W,)
    by = (np.arange(h) - 1) // 2 % h1  # (H,)
    win = out[:, 16:].reshape(h, w, 9, 4)
    for dy in range(3):
        py = (by + dy) % h1
        for dx in range(3):
            px = (bx + dx) % w1
            win[:, :, dy * 3 + dx, :] = parent[py[:, None], px[None, :]]
    return out


def build_atlas(textures: list[list[np.ndarray]]) -> TextureAtlas:
    """Pack per-texture mip pyramids ((H, W, 4) f32 linear each) into the
    flat quad-row atlas. Texture order defines texture ids.

    HOT/COLD packing: mips >= 2 of every texture are allocated FIRST,
    mip 0/1 after. The two largest mips are ~94% of the bytes but a
    minority of samples at screen resolutions (minified content samples
    mid mips), and v5e gather throughput is bound by the FOOTPRINT the
    accesses spread over — concentrating the frequently-sampled mips in
    a compact prefix keeps their DRAM locality independent of how many
    multi-hundred-MB base mips sit behind them. Offsets are absolute, so
    the sampler is unaffected.
    """
    n_tex = len(textures)
    offsets = np.zeros((n_tex, MAX_MIPS), dtype=np.int32)
    sizes = np.ones((n_tex, MAX_MIPS, 2), dtype=np.int32)
    n_mips = np.zeros(n_tex, dtype=np.int32)
    allocs = []
    cursor = 0

    def alloc(ti, mi, mips):
        nonlocal cursor
        m = mips[mi]
        h, w = m.shape[:2]
        # 256-row alignment: the resolve kernel carries offsets through
        # f32 as offset/256, which is exact only when aligned (raw
        # offsets exceed f32's 2^24 integer range on multi-GB atlases).
        cursor += (-cursor) % 256
        offsets[ti, mi] = cursor
        sizes[ti, mi] = (w, h)
        allocs.append((ti, mi, cursor))
        cursor += h * w

    for ti, mips in enumerate(textures):
        assert len(mips) <= MAX_MIPS
        # The packed parent-mip 3x3 window and the kernel-side dx/dy in
        # {0,1} anchor derivation (kernels/shade._trilerp) are only
        # wrap-invariant when every mip is exactly half the previous —
        # i.e. power-of-two base dimensions. Enforce instead of sampling
        # wrong parent texels silently (BC textures are always pow2).
        h0, w0 = mips[0].shape[:2]
        if (h0 & (h0 - 1)) or (w0 & (w0 - 1)):
            raise ValueError(
                f"texture {ti}: non-power-of-two base {w0}x{h0} breaks the "
                "single-gather trilinear atlas (parent-window anchors)"
            )
        n_mips[ti] = len(mips)
        for mi in range(2, len(mips)):  # hot zone: mips >= 2
            alloc(ti, mi, mips)
    for ti, mips in enumerate(textures):
        for mi in range(min(2, len(mips))):  # cold zone: mips 0, 1
            alloc(ti, mi, mips)
        # Clamp lod beyond the chain to the last mip.
        for mi in range(len(mips), MAX_MIPS):
            offsets[ti, mi] = offsets[ti, len(mips) - 1]
            sizes[ti, mi] = sizes[ti, len(mips) - 1]
    plan = _RowPlan(pyramids=[list(mips) for mips in textures], allocs=allocs, n_rows=cursor)
    return TextureAtlas(texels=plan, offsets=offsets, sizes=sizes, n_mips=n_mips)


TEXTURE_DTYPES = ("float32", "float16", "bfloat16", "srgb8")
_TORCH_FLOAT = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}
# texture_dtype="auto" switches to srgb8 above this f16 atlas size.
SRGB8_ABOVE_F16_BYTES = 2 << 30


# Rows converted per step of texels_tensor: 2^20 rows are 208 MiB of f32.
ROW_CHUNK = 1 << 20


def _srgb8_bounds(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The 255 decision boundaries of the u8 encode: sRGB-encoded RGB
    (in linear light) and linear alpha, f32."""
    mid = (np.arange(1, 256, dtype=np.float64) - 0.5) / 255.0
    bounds_srgb = np.where(mid <= 0.04045, mid / 12.92, ((mid + 0.055) / 1.055) ** 2.4).astype(np.float32)
    bounds_lin = ((np.arange(1, 256) - 0.5) / 255.0).astype(np.float32)
    return torch.from_numpy(bounds_srgb).to(device), torch.from_numpy(bounds_lin).to(device)


def _srgb8_encode(rows: torch.Tensor, bounds: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """(N, 52) f32 linear rows -> (N, 52) u8: RGB lanes sRGB-encoded,
    alpha lanes linear (textures.py:79-103). u8 value k is chosen iff
    x >= EOTF((k - 0.5) / 255), so one searchsorted against the 255
    boundaries gives the exact encode (torch's searchsorted is numpy's
    side="left", as the reference calls it)."""
    if rows.numel() and float(rows.max()) > 1.0 + 1e-6:
        raise ValueError("srgb8 atlas requires LDR content (texel values in [0, 1])")
    rows4 = rows.reshape(rows.shape[0], -1, 4).clamp(0.0, 1.0)
    enc = torch.empty(rows4.shape, dtype=torch.uint8, device=rows.device)
    enc[..., :3] = torch.searchsorted(bounds[0], rows4[..., :3].contiguous()).to(torch.uint8)
    enc[..., 3] = torch.searchsorted(bounds[1], rows4[..., 3].contiguous()).to(torch.uint8)
    return enc.reshape(rows.shape)


def texels_tensor(texels: np.ndarray, dtype: str, device="cpu") -> torch.Tensor:
    """The host rows as a contiguous tensor of the texel dtype on
    ``device``, converted there ROW_CHUNK rows at a time (on the card the
    conversion runs on the device, and the f32 rows never sit there
    whole). Bit for bit the reference's host conversion: torch rounds to
    nearest even on either device."""
    if dtype != "srgb8" and dtype not in _TORCH_FLOAT:
        raise ValueError(f"unknown texture dtype {dtype!r}; expected one of {TEXTURE_DTYPES}")
    dev = torch.device(device)
    out = torch.empty(texels.shape, dtype=torch.uint8 if dtype == "srgb8" else _TORCH_FLOAT[dtype], device=dev)
    bounds = _srgb8_bounds(dev) if dtype == "srgb8" else None
    for a in range(0, texels.shape[0], ROW_CHUNK):
        rows = torch.from_numpy(np.ascontiguousarray(texels[a : a + ROW_CHUNK], dtype=np.float32)).to(dev)
        out[a : a + rows.shape[0]] = _srgb8_encode(rows, bounds) if bounds is not None else rows.to(out.dtype)
    return out


def upload_atlas(atlas, dtype: str, device) -> dict:
    """TextureAtlas.device(dtype) as torch tensors on ``device``:
    {"texels" (N, 52), "offsets" (T, 16), "sizes" (T, 16, 2), "n_mips" (T,)}."""
    dev = torch.device(device)
    return {
        "texels": texels_tensor(atlas.texels, dtype, dev),
        "offsets": torch.from_numpy(np.array(atlas.offsets)).to(dev),
        "sizes": torch.from_numpy(np.array(atlas.sizes)).to(dev),
        "n_mips": torch.from_numpy(np.array(atlas.n_mips)).to(dev),
    }


def resolve_texture_dtype(scene, requested: str) -> str:
    """texture_dtype="auto": float16, or srgb8 when the f16 atlas would
    exceed 2 GiB and the content is LDR (tpurast/renderer.py:420-432;
    the threshold was set for the TPU's gather and has not been measured
    on the H100). Any other value is returned as it is. Decided from the
    row count and the pyramids: the rows are not built."""
    if requested != "auto":
        return requested
    atlas = scene.atlas
    # The Renderer takes a scene of either package: the reference's atlas
    # holds its rows, the port's counts them without building them.
    f16_bytes = (atlas.texels_nbytes if isinstance(atlas, TextureAtlas) else atlas.texels.nbytes) // 2
    if f16_bytes > SRGB8_ABOVE_F16_BYTES and atlas.max_value() <= 1.0 + 1e-6:
        return "srgb8"
    return "float16"
