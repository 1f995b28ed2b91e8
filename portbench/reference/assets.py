"""The reference's readers of the benchmark's generated assets.

GLB meshes as portbench/scenes/encode.py writes them (one scene of nodes
without transforms, float attributes, u32 indices, a base-color image
URI), KTX2 textures with no supercompression or with stored Zstandard
frames, BC7 blocks of mode 6 (the mode the generator writes; anything
else raises), and the sRGB and linear conversions of the
decoded texels. Written from the formats' specifications (Khronos KTX 2.0,
Khronos Data Format Specification for BC7, RFC 8878 for the frame),
independent of the program's decoders.
"""

from __future__ import annotations

import json
import struct

import numpy as np

KTX2_IDENTIFIER = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])
#: vkFormat -> (bytes per 4x4 block, sRGB, codec)
FORMATS = {145: (16, False, "bc7"), 146: (16, True, "bc7")}
BC7_WEIGHTS4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], dtype=np.int64)


def read_glb(blob: bytes) -> list[dict]:
    """The primitives of a GLB: each a dict of positions, normals, uvs (f32),
    indices (u32) and its base-color image URI."""
    magic, version, length = struct.unpack_from("<III", blob, 0)
    if magic != 0x46546C67 or version != 2:
        raise ValueError("not a glTF 2 binary")
    gltf, binary, off = None, b"", 12
    while off + 8 <= length:
        n, kind = struct.unpack_from("<II", blob, off)
        data = blob[off + 8 : off + 8 + n]
        if kind == 0x4E4F534A:
            gltf = json.loads(data)
        elif kind == 0x004E4942:
            binary = bytes(data)
        off += 8 + n + (-n % 4)

    def accessor(i: int) -> np.ndarray:
        acc = gltf["accessors"][i]
        view = gltf["bufferViews"][acc["bufferView"]]
        if "byteStride" in view or "sparse" in acc:
            raise ValueError("strided or sparse accessors are not generated")
        dtype = {5126: "<f4", 5125: "<u4"}[acc["componentType"]]
        width = {"SCALAR": 1, "VEC2": 2, "VEC3": 3}[acc["type"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        return np.frombuffer(binary, dtype=dtype, count=acc["count"] * width, offset=start).reshape(-1, width).copy()

    prims = []
    for node_index in gltf["scenes"][gltf["scene"]]["nodes"]:
        node = gltf["nodes"][node_index]
        if any(k in node for k in ("matrix", "translation", "rotation", "scale", "children")):
            raise ValueError("node transforms are not generated")
        for prim in gltf["meshes"][node["mesh"]]["primitives"]:
            attrs = prim["attributes"]
            uri = None
            if "material" in prim:
                tex = gltf["materials"][prim["material"]]["pbrMetallicRoughness"]["baseColorTexture"]["index"]
                uri = gltf["images"][gltf["textures"][tex]["source"]]["uri"]
            prims.append(dict(
                positions=accessor(attrs["POSITION"]).astype(np.float32),
                normals=accessor(attrs["NORMAL"]).astype(np.float32),
                uvs=accessor(attrs["TEXCOORD_0"]).astype(np.float32),
                indices=accessor(prim["indices"]).reshape(-1).astype(np.uint32),
                image_uri=uri,
            ))
    return prims


def _unzstd_stored(frame: bytes, size: int) -> bytes:
    """The content of a Zstandard frame made of raw blocks (RFC 8878
    3.1.1); a compressed or RLE block raises."""
    magic, fhd = struct.unpack_from("<IB", frame, 0)
    if magic != 0xFD2FB528 or not fhd & 0x20 or fhd & 0x07 or fhd & 0x04:
        raise ValueError("not a single-segment Zstandard frame without dictionary or checksum")
    off = 5 + {0: 1, 1: 2, 2: 4, 3: 8}[fhd >> 6]
    out, last = [], False
    while not last:
        head = int.from_bytes(frame[off : off + 3], "little")
        last, kind, n = bool(head & 1), (head >> 1) & 3, head >> 3
        if kind != 0:
            raise ValueError("only raw Zstandard blocks are generated")
        out.append(frame[off + 3 : off + 3 + n])
        off += 3 + n
    data = b"".join(out)
    if len(data) != size:
        raise ValueError(f"frame holds {len(data)} bytes, the level index says {size}")
    return data


def read_ktx2(blob: bytes) -> tuple[int, list[tuple[int, int, bytes]]]:
    """(vkFormat, [(width, height, block payload) per mip level, largest first])."""
    if blob[:12] != KTX2_IDENTIFIER:
        raise ValueError("not a KTX2 file")
    vk, _, width, height, _, _, _, n_levels, scheme = struct.unpack_from("<9I", blob, 12)
    if vk not in FORMATS or scheme not in (0, 2):
        raise ValueError(f"vkFormat {vk} / supercompression {scheme} is not generated")
    levels = []
    for lvl in range(max(1, n_levels)):
        off, n, size = struct.unpack_from("<3Q", blob, 80 + 24 * lvl)
        payload = blob[off : off + n]
        levels.append((max(1, width >> lvl), max(1, height >> lvl),
                       _unzstd_stored(payload, size) if scheme == 2 else payload))
    return vk, levels


def _blocks_to_image(texels: np.ndarray, width: int, height: int) -> np.ndarray:
    """(N, 16, C) texels of row-major 4x4 blocks -> (height, width, C)."""
    bx, by = max(1, (width + 3) // 4), max(1, (height + 3) // 4)
    c = texels.shape[-1]
    img = texels.reshape(by, bx, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(by * 4, bx * 4, c)
    return img[:height, :width]


def decode_bc7_mode6(data: bytes, width: int, height: int) -> np.ndarray:
    """BC7 blocks, all of mode 6, -> (height, width, 4) uint8 RGBA: 7-bit
    endpoints and a p-bit each, a 3-bit anchor index and fifteen 4-bit
    indices, palette (e0 (64 - w) + e1 w + 32) >> 6."""
    words = np.frombuffer(data, dtype="<u8").reshape(-1, 2).astype(np.uint64)
    lo, hi = words[:, 0], words[:, 1]
    if np.any((lo & np.uint64(0x7F)) != np.uint64(0x40)):
        raise ValueError("a BC7 block of a mode other than 6")

    def bits(pos: int, n: int) -> np.ndarray:
        if pos >= 64:
            v = hi >> np.uint64(pos - 64)
        elif pos + n <= 64:
            v = lo >> np.uint64(pos)
        else:
            v = (lo >> np.uint64(pos)) | (hi << np.uint64(64 - pos))
        return (v & np.uint64((1 << n) - 1)).astype(np.int64)

    p0, p1 = bits(63, 1), bits(64, 1)
    e0 = np.stack([bits(7 + 14 * c, 7) << 1 | p0 for c in range(4)], axis=1)  # (N, 4)
    e1 = np.stack([bits(14 + 14 * c, 7) << 1 | p1 for c in range(4)], axis=1)
    idx = np.stack([bits(65, 3)] + [bits(68 + 4 * (i - 1), 4) for i in range(1, 16)], axis=1)  # (N, 16)
    w = BC7_WEIGHTS4[idx][:, :, None]
    texels = (e0[:, None, :] * (64 - w) + e1[:, None, :] * w + 32) >> 6
    return _blocks_to_image(texels.astype(np.uint8), width, height)


def _eotf(c8: np.ndarray) -> np.ndarray:
    c = c8.astype(np.float32) / 255.0
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


SRGB_TABLE = _eotf(np.arange(256, dtype=np.uint8))


def srgb_to_linear(u8: np.ndarray) -> np.ndarray:
    """The sRGB EOTF of 8-bit values, in float32 (a table of the 256 codes)."""
    return SRGB_TABLE[u8]


def texture_pyramid(blob: bytes) -> list[np.ndarray]:
    """A KTX2 texture's mip levels as (H, W, 4) float32 linear RGBA: BC7-sRGB
    colour through the EOTF and alpha / 255."""
    vk, levels = read_ktx2(blob)
    _, srgb, _ = FORMATS[vk]
    mips = []
    for w, h, payload in levels:
        out = np.empty((h, w, 4), dtype=np.float32)
        img = decode_bc7_mode6(payload, w, h)
        out[..., :3] = srgb_to_linear(img[..., :3]) if srgb else img[..., :3].astype(np.float32) / 255.0
        out[..., 3] = img[..., 3].astype(np.float32) / 255.0
        mips.append(out)
    return mips


def box_mips(base: np.ndarray) -> list[np.ndarray]:
    """A float32 box-filtered mip chain down to 1 x 1."""
    mips, m = [base], base
    while m.shape[0] > 1 or m.shape[1] > 1:
        h, w = max(1, m.shape[0] // 2), max(1, m.shape[1] // 2)
        m = m[: h * 2, : w * 2].reshape(h, 2, w, 2, -1).mean(axis=(1, 3)).astype(np.float32)
        mips.append(m)
    return mips


def fallback_pyramid() -> list[np.ndarray]:
    """The reference renderer's fallback texture, bound where a draw names
    none or its file is missing: a 64 x 64 black and magenta checker of
    2 x 2-texel cells, black at the origin, alpha 128 / 255, box mips."""
    y, x = np.mgrid[0:64, 0:64]
    checker = ((x // 2 + y // 2) % 2 == 1).astype(np.float32)
    base = np.zeros((64, 64, 4), dtype=np.float32)
    base[..., 0] = checker
    base[..., 2] = checker
    base[..., 3] = 128.0 / 255.0
    return box_mips(base)
