"""KTX2 container parsing + Zstandard supercompression inflate.

First-party replacement for the libktx path the reference uses
(src/wgpu.zig:130-194 ``deviceLoadTexture`` + src/ktx.zig
``textureIterateLoadLevelFaces``): parse the KTX2 header/level index,
inflate Zstandard-supercompressed level data (every shipped asset uses
supercompressionScheme=2), and hand per-mip BC-compressed payloads to the
texture upload path. Scheme 2 is decoded by the port's own decoder
(assets/zstd.py over native/zstd.cpp), not the zstandard package, which
the GPU machine lacks; scheme 3 (zlib) by the standard library.

Format notes (Khronos KTX 2.0 spec):
  identifier(12) | vkFormat u32 | typeSize u32 | pixelWidth u32 |
  pixelHeight u32 | pixelDepth u32 | layerCount u32 | faceCount u32 |
  levelCount u32 | supercompressionScheme u32 | dfd/kvd/sgd index |
  levelCount * (byteOffset u64, byteLength u64, uncompressedByteLength u64)
Levels are indexed largest-first (level 0 = base mip).
"""

from __future__ import annotations

import dataclasses
import struct

_IDENTIFIER = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])

# Vulkan formats the reference maps (src/wgpu.zig:136-142).
VK_FORMAT_BC4_UNORM_BLOCK = 139
VK_FORMAT_BC6H_UFLOAT_BLOCK = 143
VK_FORMAT_BC6H_SFLOAT_BLOCK = 144
VK_FORMAT_BC7_UNORM_BLOCK = 145
VK_FORMAT_BC7_SRGB_BLOCK = 146

#: vkFormat -> (bytes per 4x4 block, srgb, format name)
BLOCK_FORMATS = {
    VK_FORMAT_BC4_UNORM_BLOCK: (8, False, "bc4u"),
    VK_FORMAT_BC6H_UFLOAT_BLOCK: (16, False, "bc6h_uf"),
    VK_FORMAT_BC6H_SFLOAT_BLOCK: (16, False, "bc6h_sf"),
    VK_FORMAT_BC7_UNORM_BLOCK: (16, False, "bc7"),
    VK_FORMAT_BC7_SRGB_BLOCK: (16, True, "bc7"),
}

SUPERCOMPRESSION_NONE = 0
SUPERCOMPRESSION_BASISLZ = 1
SUPERCOMPRESSION_ZSTD = 2
SUPERCOMPRESSION_ZLIB = 3


class Ktx2Error(RuntimeError):
    pass


@dataclasses.dataclass
class Ktx2Level:
    """One mip level's compressed-texture payload (post-inflate)."""

    level: int
    width: int
    height: int
    data: bytes  # BC block data, rows of ceil(w/4) blocks

    @property
    def blocks_x(self) -> int:
        return max(1, (self.width + 3) // 4)

    @property
    def blocks_y(self) -> int:
        return max(1, (self.height + 3) // 4)


@dataclasses.dataclass
class Ktx2Texture:
    vk_format: int
    width: int
    height: int
    level_count: int
    layer_count: int
    face_count: int
    supercompression: int
    levels: list[Ktx2Level]

    @property
    def format_name(self) -> str:
        return BLOCK_FORMATS[self.vk_format][2]

    @property
    def is_srgb(self) -> bool:
        return BLOCK_FORMATS[self.vk_format][1]

    @property
    def block_bytes(self) -> int:
        return BLOCK_FORMATS[self.vk_format][0]


def _inflate(data: bytes, scheme: int, uncompressed_len: int) -> bytes:
    if scheme == SUPERCOMPRESSION_NONE:
        return data
    if scheme == SUPERCOMPRESSION_ZSTD:
        from tpurast_torch.assets import zstd

        out = zstd.decompress(data, uncompressed_len)
    elif scheme == SUPERCOMPRESSION_ZLIB:
        import zlib

        out = zlib.decompress(data)
    else:
        raise Ktx2Error(f"unsupported supercompression scheme {scheme}")
    if len(out) != uncompressed_len:
        raise Ktx2Error(
            f"inflated level size {len(out)} != expected {uncompressed_len}"
        )
    return out


def parse_ktx2(blob: bytes) -> Ktx2Texture:
    if blob[:12] != _IDENTIFIER:
        raise Ktx2Error("not a KTX2 file (bad identifier)")
    (
        vk_format,
        _type_size,
        width,
        height,
        depth,
        layer_count,
        face_count,
        level_count,
        scheme,
    ) = struct.unpack_from("<9I", blob, 12)
    if vk_format not in BLOCK_FORMATS:
        raise Ktx2Error(f"unsupported vkFormat {vk_format}")
    if depth not in (0, 1) or face_count != 1 or layer_count not in (0, 1):
        raise Ktx2Error("only 2D single-layer non-array textures supported")

    # Skip dfd/kvd/sgd index (2*u32 + 2*u32 + 2*u64 = 32 bytes) at offset 48.
    level_index_off = 48 + 32
    n_levels = max(1, level_count)
    levels: list[Ktx2Level] = []
    for lvl in range(n_levels):
        byte_off, byte_len, uncompressed_len = struct.unpack_from(
            "<3Q", blob, level_index_off + 24 * lvl
        )
        payload = _inflate(blob[byte_off : byte_off + byte_len], scheme, uncompressed_len)
        levels.append(
            Ktx2Level(
                level=lvl,
                width=max(1, width >> lvl),
                height=max(1, height >> lvl),
                data=payload,
            )
        )

    return Ktx2Texture(
        vk_format=vk_format,
        width=width,
        height=height,
        level_count=n_levels,
        layer_count=layer_count,
        face_count=face_count,
        supercompression=scheme,
        levels=levels,
    )


def load_ktx2(path) -> Ktx2Texture:
    with open(path, "rb") as f:
        return parse_ktx2(f.read())
