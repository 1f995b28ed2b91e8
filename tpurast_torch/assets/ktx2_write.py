"""Minimal KTX2 writer + BC4 encoder (asset generation).

The reference ships no BC4u asset despite having the code path
(src/wgpu.zig:137, BASELINE config #3 requires "BC4u monochrome maps"),
so we generate our own: a simple max/min-endpoint BC4 encoder plus a
KTX2 container writer with Zstandard supercompression — the mirror image
of tpurast/assets/ktx2.py. The DFD block is written as a stub (size-only);
tpurast's own parser skips it, which is all these generated fixtures need.
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
    """Box-filtered full mip chain for a (H, W) uint8 image."""
    mips = [img]
    m = img.astype(np.float32)
    while m.shape[0] > 1 or m.shape[1] > 1:
        h = max(1, m.shape[0] // 2)
        w = max(1, m.shape[1] // 2)
        m = m[: h * 2, : w * 2].reshape(h, 2, w, 2).mean(axis=(1, 3))
        mips.append(np.round(m).astype(np.uint8))
    return mips


def write_ktx2(
    level_payloads: list[bytes],
    vk_format: int,
    width: int,
    height: int,
    supercompress: bool = True,
) -> bytes:
    """Assemble a KTX2 blob (2D, single layer/face, zstd-supercompressed)."""
    n = len(level_payloads)
    scheme = 2 if supercompress else 0
    if supercompress:
        import zstandard

        cctx = zstandard.ZstdCompressor(level=9)
        stored = [cctx.compress(p) for p in level_payloads]
    else:
        stored = list(level_payloads)

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
    for s in reversed(stored):
        offsets.append(cursor)
        cursor += len(s)
    offsets = offsets[::-1]

    index = struct.pack("<2I2I2Q", dfd_off, len(dfd), 0, 0, 0, 0)
    level_index = b"".join(
        struct.pack("<3Q", offsets[i], len(stored[i]), len(level_payloads[i]))
        for i in range(n)
    )
    body = b"".join(s for s in reversed(stored))
    return header + index + level_index + dfd + body


def make_bc4_ktx2(image: np.ndarray) -> bytes:
    """uint8 (H, W) image -> BC4u KTX2 blob with a full mip chain."""
    from tpurast_torch.assets.ktx2 import VK_FORMAT_BC4_UNORM_BLOCK

    mips = mip_chain_u8(np.asarray(image, dtype=np.uint8))
    payloads = [encode_bc4(m) for m in mips]
    return write_ktx2(payloads, VK_FORMAT_BC4_UNORM_BLOCK, image.shape[1], image.shape[0])
