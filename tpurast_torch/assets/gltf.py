"""glTF-binary (.glb) scene loading.

Covers exactly the feature surface the reference consumes
(src/Renderer.zig:663-948): GLB container, default scene, node hierarchy
with matrix-XOR-TRS transforms, POSITION/NORMAL/TEXCOORD_0 float accessors,
u16 (widened to u32) or u32 indices, materials' pbrMetallicRoughness
base_color_texture -> texture -> image URI.

Output is flat numpy arrays per primitive draw: interleaved-equivalent
vertex arrays (positions/normals/uvs), u32 indices, a model matrix and
normal matrix per draw (node transform -> model-to-world basis change ->
caller post_transform, src/Renderer.zig:787-807), and a material image URI.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import struct

import numpy as np

from tpurast_torch import math3d

log = logging.getLogger("tpurast_torch.assets")

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}

MAX_GLB_BYTES = 512 * 1024 * 1024  # src/Renderer.zig:670-677


class GltfError(RuntimeError):
    pass


@dataclasses.dataclass
class PrimitiveDraw:
    """One draw call: a glTF primitive under a specific node transform."""

    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    uvs: np.ndarray  # (V, 2) f32
    indices: np.ndarray  # (I,) u32
    model_matrix: np.ndarray  # (4, 4) f32
    normal_matrix: np.ndarray  # (3, 3) f32
    image_uri: str | None  # base-color image URI, None -> fallback texture
    material_name: str | None
    node_name: str | None


@dataclasses.dataclass
class GltfModel:
    draws: list[PrimitiveDraw]
    image_uris: list[str]  # all image URIs in the file (texture preload list)

    @property
    def triangle_count(self) -> int:
        return sum(len(d.indices) // 3 for d in self.draws)

    @property
    def vertex_count(self) -> int:
        return sum(len(d.positions) for d in self.draws)


def _read_accessor(gltf: dict, binary: bytes, accessor_index: int) -> np.ndarray:
    """Read an accessor into a (count, components) numpy array.

    Handles byteStride (interleaved) buffer views via numpy strided views —
    the equivalent of zgltf's accessor iterators (src/Renderer.zig:885-900).
    """
    accessor = gltf["accessors"][accessor_index]
    if "sparse" in accessor:
        raise GltfError("sparse accessors not supported")
    dtype = np.dtype(_COMPONENT_DTYPES[accessor["componentType"]]).newbyteorder("<")
    ncomp = _TYPE_COUNTS[accessor["type"]]
    count = accessor["count"]

    view = gltf["bufferViews"][accessor["bufferView"]]
    if gltf["buffers"][view.get("buffer", 0)].get("uri") is not None:
        raise GltfError("external buffers not supported (GLB BIN chunk only)")
    offset = view.get("byteOffset", 0) + accessor.get("byteOffset", 0)
    elem_size = dtype.itemsize * ncomp
    stride = view.get("byteStride", elem_size)

    raw = np.frombuffer(binary, dtype=np.uint8, count=stride * (count - 1) + elem_size, offset=offset)
    strided = np.lib.stride_tricks.as_strided(
        raw, shape=(count, elem_size), strides=(stride, 1), writeable=False
    )
    return strided.reshape(-1).view(dtype).reshape(count, ncomp).copy()


def _node_local_transform(node: dict) -> np.ndarray:
    """Matrix XOR TRS (src/Renderer.zig:787-795). glTF matrices are
    column-major flat arrays; TRS composes scale-then-rotate-then-translate."""
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float32).reshape(4, 4).T
    return math3d.trs(
        node.get("translation", (0.0, 0.0, 0.0)),
        node.get("rotation", (0.0, 0.0, 0.0, 1.0)),
        node.get("scale", (1.0, 1.0, 1.0)),
    )


def _material_image_uri(gltf: dict, material_index: int | None) -> str | None:
    """material -> pbrMetallicRoughness.baseColorTexture -> texture.source ->
    image.uri (src/Renderer.zig:724-746)."""
    if material_index is None:
        return None
    material = gltf["materials"][material_index]
    texture_info = material.get("pbrMetallicRoughness", {}).get("baseColorTexture")
    if texture_info is None:
        return None
    texture = gltf["textures"][texture_info["index"]]
    source = texture.get("source")
    if source is None:
        return None
    return gltf["images"][source].get("uri")


def parse_glb(blob: bytes, post_transform: np.ndarray | None = None) -> GltfModel:
    """Parse a GLB blob into flat draw records.

    ``post_transform`` is the caller's world-space placement, applied after
    the glTF->world basis change exactly like src/Renderer.zig:797-799.
    """
    if len(blob) > MAX_GLB_BYTES:
        raise GltfError(f"GLB exceeds {MAX_GLB_BYTES} bytes")
    if len(blob) < 12:
        raise GltfError("truncated GLB header")
    magic, version, length = struct.unpack_from("<III", blob, 0)
    if magic != _GLB_MAGIC:
        raise GltfError("not a GLB file (bad magic)")
    if version != 2:
        raise GltfError(f"unsupported glTF version {version}")

    gltf_json: dict | None = None
    binary = b""
    off = 12
    while off + 8 <= min(length, len(blob)):
        chunk_len, chunk_type = struct.unpack_from("<II", blob, off)
        data = blob[off + 8 : off + 8 + chunk_len]
        if chunk_type == _CHUNK_JSON:
            gltf_json = json.loads(data)
        elif chunk_type == _CHUNK_BIN:
            binary = bytes(data)
        off += 8 + chunk_len + (-chunk_len % 4)
    if gltf_json is None:
        raise GltfError("GLB has no JSON chunk")

    if post_transform is None:
        post_transform = math3d.mat4_identity()
    model_to_world = math3d.coordinate_transform(math3d.MODEL_SPACE, math3d.WORLD_SPACE)

    if "scene" not in gltf_json:
        raise GltfError("default scene missing")  # src/Renderer.zig:753-756
    scene = gltf_json["scenes"][gltf_json["scene"]]
    top_nodes = scene.get("nodes")
    if top_nodes is None:
        raise GltfError("top-level nodes missing")

    image_uris = [img["uri"] for img in gltf_json.get("images", []) if "uri" in img]
    draws: list[PrimitiveDraw] = []

    def load_node(node_index: int, parent: np.ndarray) -> None:
        node = gltf_json["nodes"][node_index]
        # Application order: node local transform, then the accumulated
        # ancestor chain, then model->world, then post_transform
        # (src/Renderer.zig:797-799; SURVEY §2.4.2). DELIBERATE
        # DEVIATION: the reference's loadNodes (src/Renderer.zig:946)
        # passes only post_transform down the recursion and drops the
        # ancestor chain; we follow the glTF spec and accumulate it.
        # All shipped assets have flat hierarchies, where the two agree —
        # the divergence only matters for nested-node assets.
        local = math3d.compose(_node_local_transform(node), parent)
        model_matrix = math3d.compose(local, model_to_world, post_transform)
        nmat = math3d.normal_matrix(model_matrix)

        mesh_index = node.get("mesh")
        if mesh_index is not None:
            mesh = gltf_json["meshes"][mesh_index]
            for i, prim in enumerate(mesh["primitives"]):
                attrs = prim.get("attributes", {})
                missing = [a for a in ("POSITION", "NORMAL", "TEXCOORD_0") if a not in attrs]
                if missing:
                    # Skipped with an error log, like src/Renderer.zig:868-879.
                    log.error("primitive %d missing vertex attribute(s): %s", i, missing)
                    continue
                if "indices" not in prim:
                    continue  # unindexed silently skipped (src/Renderer.zig:905)
                positions = _read_accessor(gltf_json, binary, attrs["POSITION"]).astype(np.float32)
                normals = _read_accessor(gltf_json, binary, attrs["NORMAL"]).astype(np.float32)
                uvs = _read_accessor(gltf_json, binary, attrs["TEXCOORD_0"]).astype(np.float32)
                indices = (
                    _read_accessor(gltf_json, binary, prim["indices"])
                    .reshape(-1)
                    .astype(np.uint32)  # u16 widened to u32 (src/Renderer.zig:902-912)
                )
                material_index = prim.get("material")
                draws.append(
                    PrimitiveDraw(
                        positions=positions[:, :3],
                        normals=normals[:, :3],
                        uvs=uvs[:, :2],
                        indices=indices,
                        model_matrix=model_matrix,
                        normal_matrix=nmat,
                        image_uri=_material_image_uri(gltf_json, material_index),
                        material_name=(
                            gltf_json["materials"][material_index].get("name")
                            if material_index is not None
                            else None
                        ),
                        node_name=node.get("name"),
                    )
                )
        for child in node.get("children", []):
            load_node(child, local)

    identity = math3d.mat4_identity()
    for node_index in top_nodes:
        load_node(node_index, identity)

    return GltfModel(draws=draws, image_uris=image_uris)


def load_glb(path, post_transform: np.ndarray | None = None) -> GltfModel:
    with open(path, "rb") as f:
        blob = f.read()
    model = parse_glb(blob, post_transform)
    log.debug(
        "%s: %d draws, %d tris, %d verts, images=%s",
        path,
        len(model.draws),
        model.triangle_count,
        model.vertex_count,
        model.image_uris,
    )
    return model
