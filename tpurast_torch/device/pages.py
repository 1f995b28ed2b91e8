"""Texture pages for the port: tpurast.device.pages.build_pages without JAX.

The reference's build_pages reads its wrap constants through
tpurast.kernels.sampler, whose package imports jax. This module repeats
build_pages line for line with the constants taken from
tpurast_torch.kernels.sampler, and reuses everything else (the
TexturePages record, the rect padding, the packing constants) from the
reference module, which is plain numpy. tests/test_torch_scene.py holds
the two field for field.
"""

from __future__ import annotations

import numpy as np

from tpurast.device.pages import (
    MAX_MIPS,
    PAGE_MARGIN_X,
    PAGE_MARGIN_Y,
    TAIL_H,
    TAIL_W,
    TexturePages,
    _rect_with_border,
)
from tpurast_torch.kernels.sampler import WRAP_GHOST, X_WRAP_LIM, Y_WRAP_LIM


def _border_for(h: int, w: int) -> tuple[int, int]:
    """Per-axis ghost border width of a mip rect (tpurast/device/pages.py
    _border_for): 1 texel on axes a sampler window holds whole,
    WRAP_GHOST on bigger ones."""
    return (
        1 if h <= Y_WRAP_LIM else WRAP_GHOST,
        1 if w <= X_WRAP_LIM else WRAP_GHOST,
    )


def build_pages(textures: list[list[np.ndarray]]) -> TexturePages:
    """Pack every (texture, mip) rect into one channel-planar page
    (tpurast/device/pages.py build_pages: tail strips on top, big rects
    shelf-packed below, origins/sizes clamped past each mip chain)."""
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
            # The origin points at ghost texel (-1, -1) whatever the
            # border width (resolve's page base = origin + 1).
            origins[ti, mi] = (oy + by - 1, ox + bx - 1)
        for mi in range(len(mips), MAX_MIPS):
            origins[ti, mi] = origins[ti, len(mips) - 1]
    return TexturePages(
        planes=planes, origins=origins, sizes=sizes, n_mips=n_mips
    )
