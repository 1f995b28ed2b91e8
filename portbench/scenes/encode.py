"""Writers of the benchmark's generated assets: BC7 blocks, KTX2
containers and glTF binaries.

Frozen copies of the encoders the port's tools use to write its stand-in
data (tpurast_torch/assets/ktx2_write.py: mip_chain_u8,
encode_bc7_mode6 with its helpers, zstd_frame_stored, write_ktx2 without
the zstandard branch; tpurast_torch/assets/glb_write.py: write_glb). The
benchmark writes its inputs with these, so that a later change to the
program cannot change what the benchmark feeds it.
"""

from __future__ import annotations

import json
import struct

import numpy as np

VK_FORMAT_BC7_SRGB_BLOCK = 146
KTX2_IDENTIFIER = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])
ZSTD_MAGIC = 0xFD2FB528
ZSTD_BLOCK_MAX = 128 * 1024


def mip_chain_u8(img: np.ndarray) -> list[np.ndarray]:
    """Box-filtered full mip chain of a (H, W) or (H, W, C) uint8 image."""
    mips = [img]
    m = img.astype(np.float32)
    while m.shape[0] > 1 or m.shape[1] > 1:
        h = max(1, m.shape[0] // 2)
        w = max(1, m.shape[1] // 2)
        m = m[: h * 2, : w * 2].reshape(h, 2, w, 2, *m.shape[2:]).mean(axis=(1, 3))
        mips.append(np.round(m).astype(np.uint8))
    return mips


def _blocks_4x4(img: np.ndarray) -> np.ndarray:
    h, w, c = img.shape
    bh, bw = -(-h // 4), -(-w // 4)
    padded = np.pad(img, ((0, bh * 4 - h), (0, bw * 4 - w), (0, 0)), mode="edge")
    return padded.reshape(bh, 4, bw, 4, c).transpose(0, 2, 1, 3, 4).reshape(-1, 16, c)


def _project_indices(px: np.ndarray, e0: np.ndarray, e1: np.ndarray, levels: int) -> np.ndarray:
    d = (e1 - e0).astype(np.float64)
    dd = (d * d).sum(axis=1)
    t = ((px - e0[:, None, :]) * d[:, None, :]).sum(axis=2) / np.where(dd > 0, dd, 1.0)[:, None]
    return np.clip(np.rint(t * (levels - 1)), 0, levels - 1).astype(np.int64)


def _pack_fields(fields: list[tuple[np.ndarray, int]]) -> bytes:
    n = fields[0][0].shape[0]
    words = np.zeros((n, 2), dtype=np.uint64)
    pos = 0
    for value, width in fields:
        v = np.asarray(value, dtype=np.uint64) & np.uint64((1 << width) - 1)
        word, shift = divmod(pos, 64)
        words[:, word] |= v << np.uint64(shift)
        if shift + width > 64:
            words[:, word + 1] |= v >> np.uint64(64 - shift)
        pos += width
    if pos != 128:
        raise ValueError(f"BC7 block fields take {pos} bits, not 128")
    return words.astype("<u8").tobytes()


def encode_bc7_mode6(image: np.ndarray) -> bytes:
    """(H, W, 4) uint8 RGBA -> BC7 mode-6 blocks (16 bytes each): 7-bit
    endpoints with a p-bit each (low 0, high 1), 4-bit indices."""
    px = _blocks_4x4(np.asarray(image, dtype=np.uint8)).astype(np.int64)
    lo7, hi7 = px.min(axis=1) >> 1, px.max(axis=1) >> 1
    idx = _project_indices(px, lo7 << 1, hi7 << 1 | 1, 16)
    n = len(px)
    e0 = np.concatenate([lo7, np.zeros((n, 1), np.int64)], axis=1)
    e1 = np.concatenate([hi7, np.ones((n, 1), np.int64)], axis=1)
    flip = idx[:, 0] >= 8
    e0, e1 = np.where(flip[:, None], e1, e0), np.where(flip[:, None], e0, e1)
    idx = np.where(flip[:, None], 15 - idx, idx)
    fields = [(np.full(n, 1 << 6), 7)]
    for ch in range(4):
        fields += [(e0[:, ch], 7), (e1[:, ch], 7)]
    fields += [(e0[:, 4], 1), (e1[:, 4], 1)]
    fields += [(idx[:, 0], 3)] + [(idx[:, i], 4) for i in range(1, 16)]
    return _pack_fields(fields)


def zstd_frame_stored(data: bytes) -> bytes:
    """A single-segment Zstandard frame holding ``data`` in raw blocks."""
    n = len(data)
    if n < 256:
        flag, fcs = 0, struct.pack("<B", n)
    elif n < 65536 + 256:
        flag, fcs = 1, struct.pack("<H", n - 256)
    elif n < 1 << 32:
        flag, fcs = 2, struct.pack("<I", n)
    else:
        flag, fcs = 3, struct.pack("<Q", n)
    parts = [struct.pack("<IB", ZSTD_MAGIC, flag << 6 | 1 << 5), fcs]
    for start in range(0, n, ZSTD_BLOCK_MAX) if n else [0]:
        size = min(ZSTD_BLOCK_MAX, n - start)
        last = int(start + ZSTD_BLOCK_MAX >= n)
        parts.append((size << 3 | last).to_bytes(3, "little"))
        parts.append(data[start : start + size])
    return b"".join(parts)


def write_ktx2(level_payloads: list[bytes], vk_format: int, width: int, height: int, stored: bool) -> bytes:
    """A 2D single-layer KTX2 blob: scheme 2 with stored Zstandard frames
    (``stored``), or no supercompression."""
    n = len(level_payloads)
    levels = [zstd_frame_stored(p) for p in level_payloads] if stored else list(level_payloads)
    header = KTX2_IDENTIFIER + struct.pack("<9I", vk_format, 1, width, height, 0, 0, 1, n, 2 if stored else 0)
    dfd_off = len(header) + 32 + 24 * n
    dfd = struct.pack("<I", 4)
    cursor = dfd_off + len(dfd)
    offsets = []
    for s in reversed(levels):
        offsets.append(cursor)
        cursor += len(s)
    offsets = offsets[::-1]
    index = struct.pack("<2I2I2Q", dfd_off, len(dfd), 0, 0, 0, 0)
    level_index = b"".join(struct.pack("<3Q", offsets[i], len(levels[i]), len(level_payloads[i])) for i in range(n))
    return header + index + level_index + dfd + b"".join(reversed(levels))


def bc7_ktx2(img: np.ndarray) -> bytes:
    """(H, W, 4) uint8 RGBA -> BC7-sRGB KTX2 with a full mip chain, in stored
    Zstandard frames (scheme 2, as the reference's assets are)."""
    payloads = [encode_bc7_mode6(m) for m in mip_chain_u8(img)]
    return write_ktx2(payloads, VK_FORMAT_BC7_SRGB_BLOCK, img.shape[1], img.shape[0], stored=True)


def write_glb(positions, normals, uvs, indices, *, image_uri: str | None, generator: str, name: str) -> bytes:
    """A GLB blob of one triangle mesh: one scene, one node, one primitive
    with float POSITION / NORMAL / TEXCOORD_0 and u32 indices, and a
    material binding ``image_uri`` where one is given."""
    arrays = [
        ("POSITION", np.ascontiguousarray(positions, dtype="<f4").reshape(-1, 3), "VEC3"),
        ("NORMAL", np.ascontiguousarray(normals, dtype="<f4").reshape(-1, 3), "VEC3"),
        ("TEXCOORD_0", np.ascontiguousarray(uvs, dtype="<f4").reshape(-1, 2), "VEC2"),
    ]
    idx = np.ascontiguousarray(indices, dtype="<u4").reshape(-1)
    n_vertices = arrays[0][1].shape[0]
    bin_parts, views, accessors, attributes = [], [], [], {}
    offset = 0
    for key, a, kind in arrays:
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": a.nbytes, "target": 34962})
        acc = {"bufferView": len(views) - 1, "componentType": 5126, "count": n_vertices, "type": kind}
        if key == "POSITION" and n_vertices:
            acc["min"] = [float(v) for v in a.min(axis=0)]
            acc["max"] = [float(v) for v in a.max(axis=0)]
        attributes[key] = len(accessors)
        accessors.append(acc)
        bin_parts.append(a.tobytes())
        offset += a.nbytes
    views.append({"buffer": 0, "byteOffset": offset, "byteLength": idx.nbytes, "target": 34963})
    accessors.append({"bufferView": len(views) - 1, "componentType": 5125, "count": int(idx.size), "type": "SCALAR"})
    bin_parts.append(idx.tobytes())
    binary = b"".join(bin_parts)
    primitive = {"attributes": attributes, "indices": len(accessors) - 1}
    gltf = {
        "asset": {"version": "2.0", "generator": generator},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": name}],
        "meshes": [{"name": name, "primitives": [primitive]}],
        "accessors": accessors,
        "bufferViews": views,
        "buffers": [{"byteLength": len(binary)}],
    }
    if image_uri is not None:
        primitive["material"] = 0
        gltf["images"] = [{"uri": image_uri}]
        gltf["textures"] = [{"source": 0}]
        gltf["materials"] = [{"name": name, "pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}]
    js = json.dumps(gltf, separators=(",", ":")).encode()
    js += b" " * (-len(js) % 4)
    binary += b"\0" * (-len(binary) % 4)
    total = 12 + 8 + len(js) + 8 + len(binary)
    return b"".join([
        struct.pack("<III", 0x46546C67, 2, total),
        struct.pack("<II", len(js), 0x4E4F534A), js,
        struct.pack("<II", len(binary), 0x004E4942), binary,
    ])
