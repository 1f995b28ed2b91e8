"""Minimal KTX2 writer + BC4, BC7 and BC6H encoders (asset generation).

The reference ships no BC4u asset despite having the code path
(src/wgpu.zig:137, BASELINE config #3 requires "BC4u monochrome maps"),
so we generate our own: a simple max/min-endpoint BC4 encoder plus a
KTX2 container writer with Zstandard supercompression — the mirror image
of tpurast/assets/ktx2.py. The DFD block is written as a stub (size-only);
tpurast's own parser skips it, which is all these generated fixtures need.

The stand-in data directory (tpurast_torch/tools/standin_data.py) also
needs BC7-sRGB and BC6H-ufloat textures: ``encode_bc7_mode6`` and
``encode_bc6h_mode3`` write one fixed mode each (endpoints from the
block's extremes, indices by projection onto the endpoint axis). No
fidelity is asked of them. Scheme-2 levels are compressed with the
zstandard package where it is installed, or written as stored frames
(``zstd_frame_stored``) where it is not.
"""

from __future__ import annotations

import struct

import numpy as np

_IDENTIFIER = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])


def encode_bc4(image: np.ndarray) -> bytes:
    """Encode a (H, W) uint8 image to BC4-unorm blocks (8 bytes/block).

    Per block: endpoints = (max, min) (8-step interpolated mode when they
    differ), indices = nearest palette entry. Not rate-optimal, exact for
    2-level content.
    """
    img = np.asarray(image, dtype=np.uint8)
    h, w = img.shape
    bh, bw = -(-h // 4), -(-w // 4)
    padded = np.zeros((bh * 4, bw * 4), dtype=np.uint8)
    padded[:h, :w] = img
    # Replicate edges into padding so endpoints aren't polluted.
    padded[h:, :w] = img[h - 1 : h, :]
    padded[:, w:] = padded[:, w - 1 : w]

    blocks = padded.reshape(bh, 4, bw, 4).transpose(0, 2, 1, 3).reshape(-1, 16)
    r0 = blocks.max(axis=1).astype(np.int64)  # r0 > r1 -> 8-step mode
    r1 = blocks.min(axis=1).astype(np.int64)
    same = r0 == r1
    r1 = np.where(same, np.maximum(r1 - 1, 0), r1)
    r0 = np.where(same & (r0 == 0), 1, r0)

    k = np.arange(1, 7, dtype=np.int64)
    pal = np.concatenate(
        [r0[:, None], r1[:, None], ((7 - k) * r0[:, None] + k * r1[:, None]) // 7],
        axis=1,
    )  # (N, 8)
    dist = np.abs(blocks[:, :, None].astype(np.int64) - pal[:, None, :])
    idx = np.argmin(dist, axis=2).astype(np.uint64)  # (N, 16)

    out = np.zeros((len(blocks), 8), dtype=np.uint8)
    out[:, 0] = r0.astype(np.uint8)
    out[:, 1] = r1.astype(np.uint8)
    bits = np.zeros(len(blocks), dtype=np.uint64)
    for i in range(16):
        bits |= idx[:, i] << np.uint64(3 * i)
    for b in range(6):
        out[:, 2 + b] = ((bits >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
    return out.tobytes()


def mip_chain_u8(img: np.ndarray) -> list[np.ndarray]:
    """Box-filtered full mip chain for a (H, W) or (H, W, C) uint8 image."""
    mips = [img]
    m = img.astype(np.float32)
    while m.shape[0] > 1 or m.shape[1] > 1:
        h = max(1, m.shape[0] // 2)
        w = max(1, m.shape[1] // 2)
        m = m[: h * 2, : w * 2].reshape(h, 2, w, 2, *m.shape[2:]).mean(axis=(1, 3))
        mips.append(np.round(m).astype(np.uint8))
    return mips


def _blocks_4x4(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (N, 16, C) 4x4 blocks in row-major block order, the
    image's last row and column repeated into a partial block."""
    h, w, c = img.shape
    bh, bw = -(-h // 4), -(-w // 4)
    padded = np.pad(img, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)), mode="edge")
    return padded.reshape(bh, 4, bw, 4, c).transpose(0, 2, 1, 3, 4).reshape(-1, 16, c)


def _project_indices(px: np.ndarray, e0: np.ndarray, e1: np.ndarray, levels: int) -> np.ndarray:
    """Each pixel's palette index: its projection onto the e0 -> e1 axis,
    rounded to one of ``levels`` steps. px (N, 16, C), e0/e1 (N, C)."""
    d = (e1 - e0).astype(np.float64)
    dd = (d * d).sum(axis=1)
    t = ((px - e0[:, None, :]) * d[:, None, :]).sum(axis=2) / np.where(dd > 0, dd, 1.0)[:, None]
    return np.clip(np.rint(t * (levels - 1)), 0, levels - 1).astype(np.int64)


def _pack_fields(fields: list[tuple[np.ndarray, int]]) -> bytes:
    """Per block, the (value, width) fields LSB first: (N, 16) bytes."""
    n = fields[0][0].shape[0]
    words = np.zeros((n, 2), dtype=np.uint64)  # bits 0-63, 64-127
    pos = 0
    for value, width in fields:
        v = np.asarray(value, dtype=np.uint64) & np.uint64((1 << width) - 1)
        word, shift = divmod(pos, 64)
        words[:, word] |= v << np.uint64(shift)
        if shift + width > 64:
            words[:, word + 1] |= v >> np.uint64(64 - shift)
        pos += width
    assert pos == 128
    return words.astype("<u8").tobytes()


def _anchor_first(idx: np.ndarray, e0: np.ndarray, e1: np.ndarray, levels: int):
    """Swap the endpoints of blocks whose first index has its high bit set
    (the anchor pixel stores one bit less) and invert their indices."""
    flip = idx[:, 0] >= levels // 2
    e0, e1 = np.where(flip[:, None], e1, e0), np.where(flip[:, None], e0, e1)
    return np.where(flip[:, None], levels - 1 - idx, idx), e0, e1


def _index_fields(idx: np.ndarray) -> list[tuple[np.ndarray, int]]:
    return [(idx[:, 0], 3)] + [(idx[:, i], 4) for i in range(1, 16)]


def encode_bc7_mode6(image: np.ndarray) -> bytes:
    """Encode a (H, W, 4) uint8 RGBA image to BC7 mode-6 blocks (16 bytes
    each): 7-bit RGBA endpoints with a p-bit each, 4-bit indices. The
    low endpoint takes p-bit 0 and the high one p-bit 1, so the block's
    range lies between them."""
    px = _blocks_4x4(np.asarray(image, dtype=np.uint8)).astype(np.int64)
    lo7, hi7 = px.min(axis=1) >> 1, px.max(axis=1) >> 1
    idx = _project_indices(px, lo7 << 1, hi7 << 1 | 1, 16)
    # Endpoints as (R, G, B, A, p-bit) rows, so that a swap moves the p-bit too.
    n = len(px)
    e0 = np.concatenate([lo7, np.zeros((n, 1), np.int64)], axis=1)
    e1 = np.concatenate([hi7, np.ones((n, 1), np.int64)], axis=1)
    idx, e0, e1 = _anchor_first(idx, e0, e1, 16)
    fields = [(np.full(n, 1 << 6), 7)]
    for ch in range(4):
        fields += [(e0[:, ch], 7), (e1[:, ch], 7)]
    fields += [(e0[:, 4], 1), (e1[:, 4], 1)]
    return _pack_fields(fields + _index_fields(idx))


def encode_bc6h_mode3(image: np.ndarray) -> bytes:
    """Encode a (H, W, 3) float image (values in [0, 65504]) to BC6H-ufloat
    blocks of mode 0x03 (16 bytes each): 10-bit endpoints stored directly,
    4-bit indices. Endpoints bracket the block's half-float bit patterns
    (the decoder interpolates those), so 65504 stays reachable."""
    half = np.clip(np.asarray(image, dtype=np.float32), 0.0, 65504.0).astype(np.float16).view(np.uint16)
    px = _blocks_4x4(half).astype(np.int64)
    # The decoder's half bits of a 10-bit endpoint q: (q * 64 + 32) * 31 >> 6
    # (q = 0 gives 0, q = 1023 gives 0x7BFF); bracket the block with q.
    lo = np.clip((px.min(axis=1) - 15) // 31, 0, 1023)
    hi = np.clip(-(-px.max(axis=1) // 31), 0, 1023)

    def half_of(q):
        u = np.where(q == 0, 0, np.where(q == 1023, 0xFFFF, q * 64 + 32))
        return (u * 31) >> 6

    idx = _project_indices(px, half_of(lo), half_of(hi), 16)
    idx, e0, e1 = _anchor_first(idx, lo, hi, 16)
    fields = [(np.full(len(px), 0x03), 5)]
    fields += [(e0[:, ch], 10) for ch in range(3)] + [(e1[:, ch], 10) for ch in range(3)]
    return _pack_fields(fields + _index_fields(idx))


ZSTD_MAGIC = 0xFD2FB528
ZSTD_BLOCK_MAX = 128 * 1024


def zstd_frame_stored(data: bytes) -> bytes:
    """A single-segment Zstandard frame holding ``data`` uncompressed: raw
    blocks of at most 128 KiB, the content size, no checksum (RFC 8878
    3.1.1). Scheme-2 KTX2 levels written where no compressor is
    installed."""
    n = len(data)
    if n < 256:
        flag, fcs = 0, struct.pack("<B", n)
    elif n < 65536 + 256:
        flag, fcs = 1, struct.pack("<H", n - 256)
    elif n < 1 << 32:
        flag, fcs = 2, struct.pack("<I", n)
    else:
        flag, fcs = 3, struct.pack("<Q", n)
    parts = [struct.pack("<IB", ZSTD_MAGIC, flag << 6 | 1 << 5), fcs]  # single segment
    for start in range(0, n, ZSTD_BLOCK_MAX) if n else [0]:
        size = min(ZSTD_BLOCK_MAX, n - start)
        last = int(start + ZSTD_BLOCK_MAX >= n)
        parts.append((size << 3 | last).to_bytes(3, "little"))  # block type 0: raw
        parts.append(data[start : start + size])
    return b"".join(parts)


def write_ktx2(
    level_payloads: list[bytes],
    vk_format: int,
    width: int,
    height: int,
    supercompress: bool = True,
    stored: bool = False,
) -> bytes:
    """Assemble a KTX2 blob (2D, single layer/face, zstd-supercompressed).
    With ``stored`` the scheme-2 levels are stored frames
    (zstd_frame_stored), which need no zstandard package."""
    n = len(level_payloads)
    scheme = 2 if supercompress else 0
    if supercompress and stored:
        stored_levels = [zstd_frame_stored(p) for p in level_payloads]
    elif supercompress:
        import zstandard

        cctx = zstandard.ZstdCompressor(level=9)
        stored_levels = [cctx.compress(p) for p in level_payloads]
    else:
        stored_levels = list(level_payloads)

    header = _IDENTIFIER + struct.pack(
        "<9I", vk_format, 1, width, height, 0, 0, 1, n, scheme
    )
    # dfd/kvd/sgd index + level index sizing.
    index_off = len(header)
    level_index_off = index_off + 32
    dfd_off = level_index_off + 24 * n
    dfd = struct.pack("<I", 4)  # stub DFD: totalSize only
    data_off = dfd_off + len(dfd)
    # Levels are stored last-to-first per convention; offsets ascending.
    offsets = []
    cursor = data_off
    for s in reversed(stored_levels):
        offsets.append(cursor)
        cursor += len(s)
    offsets = offsets[::-1]

    index = struct.pack("<2I2I2Q", dfd_off, len(dfd), 0, 0, 0, 0)
    level_index = b"".join(
        struct.pack("<3Q", offsets[i], len(stored_levels[i]), len(level_payloads[i]))
        for i in range(n)
    )
    body = b"".join(s for s in reversed(stored_levels))
    return header + index + level_index + dfd + body


def make_bc4_ktx2(image: np.ndarray) -> bytes:
    """uint8 (H, W) image -> BC4u KTX2 blob with a full mip chain."""
    from tpurast_torch.assets.ktx2 import VK_FORMAT_BC4_UNORM_BLOCK

    mips = mip_chain_u8(np.asarray(image, dtype=np.uint8))
    payloads = [encode_bc4(m) for m in mips]
    return write_ktx2(payloads, VK_FORMAT_BC4_UNORM_BLOCK, image.shape[1], image.shape[0])
