"""Minimal glTF-binary (.glb) writer: ktx2_write's counterpart for meshes.

Writes one mesh per file, exactly the feature surface that
assets/gltf.py ``parse_glb`` reads (and the reference's parse_glb reads
the same way): a JSON chunk and a BIN chunk, one scene with one node, one
primitive with float POSITION / NORMAL / TEXCOORD_0 accessors and u32
indices, and, where an image URI is given, a material whose
pbrMetallicRoughness.baseColorTexture binds it (images[].uri). Positions,
normals and uvs are in glTF model space (+Y up); parse_glb applies the
model-to-world basis change.
"""

from __future__ import annotations

import json
import struct

import numpy as np

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942
_FLOAT = 5126
_UINT = 5125
_ARRAY_BUFFER = 34962
_ELEMENT_ARRAY_BUFFER = 34963


def write_glb(
    positions: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    indices: np.ndarray,
    *,
    image_uri: str | None,
    generator: str,
    name: str = "mesh",
) -> bytes:
    """A GLB blob holding one triangle mesh: (V, 3) positions and normals,
    (V, 2) uvs, (3F,) u32 indices, its base-color image URI (None: no
    material, the renderer binds its fallback texture), and
    ``asset.generator``."""
    arrays = [
        ("POSITION", np.ascontiguousarray(positions, dtype="<f4").reshape(-1, 3), "VEC3"),
        ("NORMAL", np.ascontiguousarray(normals, dtype="<f4").reshape(-1, 3), "VEC3"),
        ("TEXCOORD_0", np.ascontiguousarray(uvs, dtype="<f4").reshape(-1, 2), "VEC2"),
    ]
    idx = np.ascontiguousarray(indices, dtype="<u4").reshape(-1)
    n_vertices = arrays[0][1].shape[0]
    if any(a.shape[0] != n_vertices for _, a, _ in arrays):
        raise ValueError("positions, normals and uvs must have one row per vertex")
    if idx.size % 3 or (idx.size and int(idx.max()) >= n_vertices):
        raise ValueError("indices must be triangles of existing vertices")

    bin_parts, views, accessors, attributes = [], [], [], {}
    offset = 0
    for key, a, kind in arrays:
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": a.nbytes, "target": _ARRAY_BUFFER})
        acc = {"bufferView": len(views) - 1, "componentType": _FLOAT, "count": n_vertices, "type": kind}
        if key == "POSITION" and n_vertices:
            acc["min"] = [float(v) for v in a.min(axis=0)]
            acc["max"] = [float(v) for v in a.max(axis=0)]
        attributes[key] = len(accessors)
        accessors.append(acc)
        bin_parts.append(a.tobytes())
        offset += a.nbytes
    views.append({"buffer": 0, "byteOffset": offset, "byteLength": idx.nbytes, "target": _ELEMENT_ARRAY_BUFFER})
    accessors.append({"bufferView": len(views) - 1, "componentType": _UINT, "count": int(idx.size), "type": "SCALAR"})
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
        struct.pack("<III", _GLB_MAGIC, 2, total),
        struct.pack("<II", len(js), _CHUNK_JSON), js,
        struct.pack("<II", len(binary), _CHUNK_BIN), binary,
    ])
