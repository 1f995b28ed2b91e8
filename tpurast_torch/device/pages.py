"""Texture pages: 2D mip rectangles for the windowed sampling kernel.

A copy of tpurast/device/pages.py without TexturePages.device() (jax,
ml_dtypes; the port uploads the page in device/scene.py upload), with the
wrap constants taken from tpurast_torch.kernels.sampler. The account
below is the reference's; on the card the sample kernel stages the
planned windows in shared memory (csrc/sampler.cu).

The row atlas (device/textures.py) serves the per-pixel gather path: one
flat (N, 52) table, one row gather per trilinear sample. That design is
bound by XLA:TPU's gather throughput (~7-76 ns/row depending on table
footprint) — 2M pixel gathers/frame is tens of milliseconds on scenes
with multi-GB texture residency (the porsche class).

The windowed sampler (kernels/sampler.py) instead DMAs, per framebuffer
tile, a small window of each needed mip level into VMEM and selects
texels with one-hot MXU contractions — the TPU-native analog of a GPU
texture unit's cache. It needs textures laid out as 2D rectangles, not
quad rows:

  * one channel-planar page array (4, PH, PW) holding every (texture,
    mip) as a rect at (oy, ox);
  * each rect has wrapped ghost borders (copies of the opposite edge):
    1 texel on axes where the whole mip fits one window, WRAP_GHOST
    texels on bigger axes — so repeat addressing (the reference sampler
    state, src/Renderer.zig:506-527) never splits a window at the seam:
    a seam-crossing footprint anchors at its wrapped lo texel and reads
    its tail from the ghost copies (kernels/sampler.py wrap scheme);
  * rects are shelf-packed; the page is padded by one max-window margin
    on the bottom/right so clamped window DMAs never leave the array.

Texels are stored LINEAR (sRGB decoded at build time, like the gather
atlas) and uploaded bf16: integers 0..255 survive exactly, and general
values carry 2^-9 relative error — under half a u8 LSB through the
shading chain, within the 1-LSB/channel budget (BASELINE.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpurast_torch.kernels.sampler import WRAP_GHOST, X_WRAP_LIM, Y_WRAP_LIM

MAX_MIPS = 16

# Page rows/cols are padded by the largest window the sampler may DMA so
# clamped origins stay in bounds (kernels/sampler.py window classes).
PAGE_MARGIN_Y = 264
PAGE_MARGIN_X = 512


@dataclasses.dataclass
class TexturePages:
    planes: np.ndarray  # (4, PH, PW) f32 host staging (bf16 on device)
    origins: np.ndarray  # (T, MAX_MIPS, 2) i32: (oy, ox) of texel (-1, -1)
    sizes: np.ndarray  # (T, MAX_MIPS, 2) i32: (w, h) per mip (clamped chain)
    n_mips: np.ndarray  # (T,) i32


def _border_for(h: int, w: int) -> tuple[int, int]:
    """Per-axis ghost border width for a mip rect (kernels/sampler.py
    wrap scheme): small axes (mip fits a window whole) keep the 1-texel
    bilinear border; big axes get WRAP_GHOST wrapped texels on BOTH
    sides so a seam-crossing footprint anchored at its wrapped lo can
    read its tail past the mip edge from one contiguous window."""
    return (
        1 if h <= Y_WRAP_LIM else WRAP_GHOST,
        1 if w <= X_WRAP_LIM else WRAP_GHOST,
    )


def _rect_with_border(m: np.ndarray, by: int, bx: int) -> np.ndarray:
    """(H, W, 4) mip -> (H+2by, W+2bx, 4) with wrapped ghost borders."""
    # np.pad(mode="wrap") requires pad <= dim; tile first when the
    # border exceeds the mip (only possible for degenerate mid-chain
    # sizes — tail mips take the 1-texel branch).
    h, w = m.shape[:2]
    if by > h or bx > w:
        reps = (-(-by // h) * 2 + 1, -(-bx // w) * 2 + 1, 1)
        t = np.tile(m, reps)
        cy, cx = (reps[0] // 2) * h, (reps[1] // 2) * w
        return t[cy - by : cy + h + by, cx - bx : cx + w + bx]
    return np.pad(m, ((by, by), (bx, bx), (0, 0)), mode="wrap")


# Mip-tail region geometry: rects at most this tall/wide pack densely
# into TAIL_W-wide strips so one sampler window (COV 87x255 anchors,
# kernels/sampler.py) covers MANY small mips at once — the covering
# works in page coordinates, so horizon tiles that touch a dozen
# (texture, mip) tails cost 1-2 windows instead of a dozen.
TAIL_H = 66  # mips <= 64 px tall (incl. ghost border)
TAIL_W = 248


def build_pages(textures: list[list[np.ndarray]]) -> TexturePages:
    """Pack every (texture, mip) rect into one channel-planar page.

    Two regions: small "tail" mips pack densely (no alignment — window
    origins align themselves) into TAIL_W-wide strips at the page top;
    big rects shelf-pack below, tallest first. Beyond each texture's
    mip chain, origins/sizes clamp to the last mip (same convention as
    the gather atlas) so lod clamping needs no bounds logic in the
    kernel.
    """
    n_tex = len(textures)
    origins = np.zeros((n_tex, MAX_MIPS, 2), dtype=np.int32)
    sizes = np.ones((n_tex, MAX_MIPS, 2), dtype=np.int32)
    n_mips = np.zeros(n_tex, dtype=np.int32)

    rects = []  # (h+2by, w+2bx, ti, mi)
    borders = {}
    for ti, mips in enumerate(textures):
        assert len(mips) <= MAX_MIPS
        n_mips[ti] = len(mips)
        for mi, m in enumerate(mips):
            h, w = m.shape[:2]
            sizes[ti, mi] = (w, h)
            by, bx = borders[(ti, mi)] = _border_for(h, w)
            rects.append((h + 2 * by, w + 2 * bx, ti, mi))
        for mi in range(len(mips), MAX_MIPS):
            sizes[ti, mi] = sizes[ti, len(mips) - 1]

    max_w = max((r[1] for r in rects), default=1)
    page_w = max(512, -(-max_w // 128) * 128)

    def up(x, m):
        return -(-x // m) * m

    placements = {}
    y_cursor = 0

    # Tail region: dense shelves, strip width TAIL_W.
    tail = [r for r in rects if r[0] <= TAIL_H and r[1] <= TAIL_W]
    big = [r for r in rects if not (r[0] <= TAIL_H and r[1] <= TAIL_W)]
    shelves: list[list[int]] = []  # per shelf: [y, height, cursor_x]
    for rh, rw, ti, mi in sorted(tail, reverse=True):
        placed = False
        for shelf in shelves:
            if rh <= shelf[1] and shelf[2] + rw <= TAIL_W:
                placements[(ti, mi)] = (shelf[0], shelf[2])
                shelf[2] += rw
                placed = True
                break
        if not placed:
            shelves.append([y_cursor, rh, rw])
            placements[(ti, mi)] = (y_cursor, 0)
            y_cursor += rh

    # Big rects: classic shelf pack, tallest first.
    y_cursor = up(y_cursor, 16)
    shelves = []
    for rh, rw, ti, mi in sorted(big, reverse=True):
        placed = False
        for shelf in shelves:
            x_pos = up(shelf[2], 128)
            if rh <= shelf[1] and x_pos + rw <= page_w:
                placements[(ti, mi)] = (shelf[0], x_pos)
                shelf[2] = x_pos + rw
                placed = True
                break
        if not placed:
            shelves.append([y_cursor, rh, rw])
            placements[(ti, mi)] = (y_cursor, 0)
            y_cursor = up(y_cursor + rh, 16)

    page_h = y_cursor + PAGE_MARGIN_Y
    planes = np.zeros((4, page_h, page_w + PAGE_MARGIN_X), dtype=np.float32)
    for ti, mips in enumerate(textures):
        for mi, m in enumerate(mips):
            oy, ox = placements[(ti, mi)]
            by, bx = borders[(ti, mi)]
            r = _rect_with_border(np.asarray(m, dtype=np.float32), by, bx)
            planes[:, oy : oy + r.shape[0], ox : ox + r.shape[1]] = np.moveaxis(
                r, -1, 0
            )
            # The origin convention points at ghost texel (-1, -1)
            # regardless of border width (resolve's page_base = origin+1).
            origins[ti, mi] = (oy + by - 1, ox + bx - 1)
        for mi in range(len(mips), MAX_MIPS):
            origins[ti, mi] = origins[ti, len(mips) - 1]
    return TexturePages(
        planes=planes, origins=origins, sizes=sizes, n_mips=n_mips
    )
