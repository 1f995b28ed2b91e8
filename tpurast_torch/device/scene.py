"""Scene residency for the port: host build, upload and a procedural scene.

``DeviceScene``, ``_pad_to``, ``_round_up`` and ``build_scene`` are
copies of tpurast/device/scene.py's (DeviceScene without device(), which
imports jax): the same fields, so a scene built by either package renders
through the port. ``load_demo_scene`` and the bench's named scenes
(``replicate_model``, ``load_instanced_dragons``, ``load_hdr_scene``,
``load_porsche_class_scene``) are the reference's loaders over this
build_scene; they read the reference's data directory (meshes/,
textures/), which is not part of the repository.

``upload(scene, device, texture_dtype=None)`` is the port's counterpart of
DeviceScene.device(): the frame's inputs as torch tensors on ``device``.
It carries the corner tables, face_tex and n_faces, the atlas
offsets/sizes/n_mips that resolve reads and, when the scene has pages,
the bf16 texture page with its origins, sizes and mip counts. The
quad-row atlas texels, which only the gather sampler reads, are added
in ``texture_dtype`` (device/textures.py) when one is given.
``from_numpy(tree, device)`` takes the same state from the reference's
device() pytree converted leaf by leaf with np.asarray, so tests can
feed both packages identical state. ``replicate(scene_dev, device)``
copies an uploaded scene to another device (parallel.py's mesh).

``build_orbit_scene`` / ``orbit_track`` generate the procedural scene that
chip_smoke.py renders (and the CPU tests at a small size): a textured
floor grid, a grid of UV spheres and generated BC4 textures, all from a
seed, with no files from outside the repository.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import math
import os

import numpy as np
import torch

from tpurast_torch import math3d, tracing
from tpurast_torch.assets.gltf import GltfModel, PrimitiveDraw, load_glb
from tpurast_torch.assets.ktx2 import load_ktx2, parse_ktx2
from tpurast_torch.camera import Camera
from tpurast_torch.device import textures as tex_mod
from tpurast_torch.device.pages import build_pages
from tpurast_torch.device.textures import texels_tensor
from tpurast_torch.kernels.sampler import interleave_page
from tpurast_torch.kernels.shade import srgb_table

log = logging.getLogger("tpurast_torch.device")


def _pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    pad_block = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad_block], axis=0)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class DeviceScene:
    """Host-staged scene; ``upload`` returns the frame function's torch
    tensors. All array sizes are padded to static shapes."""

    positions: np.ndarray  # (Vp, 3) f32, model space
    normals: np.ndarray  # (Vp, 3) f32, model space
    uvs: np.ndarray  # (Vp, 2) f32
    vert_prim: np.ndarray  # (Vp,) i32
    faces: np.ndarray  # (Fp, 3) i32, global vertex indices
    face_prim: np.ndarray  # (Fp,) i32
    n_faces: int
    n_vertices: int
    models: np.ndarray  # (P, 4, 4) f32
    normal_mats: np.ndarray  # (P, 3, 3) f32
    prim_tex: np.ndarray  # (P,) i32 texture id (0 = fallback)
    atlas: tex_mod.TextureAtlas
    texture_uris: list[str]
    # 2D mip rects for the windowed sampling kernel (device/pages.py);
    # None disables the windowed path for this scene.
    pages: "object | None" = None
    # Build-time face-corner tables (world space). The model->world half
    # of the vertex stage plus ALL vertex->face gathers run once here:
    # per frame the geometry stage is pure arithmetic over (Fp, 3, ...)
    # corner rows (kernels/geometry.transform_corners) — XLA:TPU dynamic
    # row gathers cost ~7-76 ns each, so gathering 5 rows per face per
    # frame dominated geometry on 100k+-face scenes.
    corner_world: np.ndarray | None = None  # (Fp, 3, 3) f32
    corner_normal: np.ndarray | None = None  # (Fp, 3, 3) f32
    corner_uv: np.ndarray | None = None  # (Fp, 3, 2) f32
    face_tex: np.ndarray | None = None  # (Fp,) i32 = prim_tex[face_prim]
    # Retired fields kept for pickle compatibility with cached scenes:
    # UV chart ids (device/charts.py) fed an earlier windowed-sampler
    # plan; the page-coordinate covering subsumed them, so they are no
    # longer computed, uploaded, or read (host tooling that wants charts
    # calls charts.face_charts directly, e.g. tools/residual_analysis.py).
    face_chart: np.ndarray | None = None  # (Fp,) i32
    n_charts: int = 1

    @property
    def triangle_count(self) -> int:
        return self.n_faces

    def page_dtype(self) -> str:
        """bf16 pages: 2^-9 relative texel error, under half a u8 LSB
        through the shading chain (and the MXU selection runs bf16
        regardless — f32 pages would round identically in the matmul)."""
        return "bfloat16"

    def corner_tables(self):
        """World-space face-corner tables, computed once (host).

        Runs basic.vert's model->world half (world = model * pos, normal
        via the 3x3 normal matrix, src/Renderer.zig:797-807 transforms
        are static per scene) and bakes the vertex->face indirection, so
        the per-frame vertex stage has zero dynamic gathers."""
        if self.corner_world is None:
            m = self.models[self.vert_prim]  # (Vp, 4, 4)
            ph = np.concatenate(
                [self.positions, np.ones_like(self.positions[:, :1])], axis=1
            )
            world = np.einsum("vij,vj->vi", m, ph).astype(np.float32)[:, :3]
            nm = self.normal_mats[self.vert_prim]
            wnormal = np.einsum("vij,vj->vi", nm, self.normals).astype(np.float32)
            self.corner_world = world[self.faces]
            self.corner_normal = wnormal[self.faces]
            self.corner_uv = self.uvs[self.faces]
        return self.corner_world, self.corner_normal, self.corner_uv


def build_scene(
    models: list[GltfModel],
    data_dir: str | os.PathLike | None = None,
    face_pad: int = 256,
    vert_pad: int = 128,
    memory_assets: dict[str, bytes] | None = None,
) -> DeviceScene:
    """Assemble parsed models into flat buffers + texture atlas + pages
    (tpurast/device/scene.py build_scene, same arguments and result),
    inside the ``setup.scene`` span (tracing.py)."""
    span = tracing.SETUP_SCENE.begin()
    try:
        return _build_scene(models, data_dir, face_pad, vert_pad, memory_assets)
    finally:
        tracing.SETUP_SCENE.end(span)


def _build_scene(models, data_dir, face_pad, vert_pad, memory_assets) -> DeviceScene:
    draws: list[PrimitiveDraw] = [d for m in models for d in m.draws]

    # Texture registry: id 0 is the fallback; others keyed by URI.
    uri_to_id: dict[str, int] = {}
    pyramids: list[list[np.ndarray]] = [tex_mod.fallback_texture(data_dir)]
    texture_uris = ["builtin://fallback-texture"]

    def texture_id(uri: str | None) -> int:
        if uri is None:
            return 0
        if uri in uri_to_id:
            return uri_to_id[uri]
        if memory_assets is not None and uri in memory_assets:
            ktx = parse_ktx2(memory_assets[uri])
            pyramids.append(tex_mod.decode_ktx2_texture(ktx))
            tid = len(pyramids) - 1
            uri_to_id[uri] = tid
            texture_uris.append(uri)
            return tid
        path = os.path.join(data_dir, uri) if data_dir is not None else uri
        if not os.path.exists(path):
            log.error("failed to find texture: %s", uri)
            uri_to_id[uri] = 0
            return 0
        ktx = load_ktx2(path)
        pyramids.append(tex_mod.decode_ktx2_texture(ktx))
        tid = len(pyramids) - 1
        uri_to_id[uri] = tid
        texture_uris.append(uri)
        return tid

    positions, normals, uvs, vert_prim = [], [], [], []
    faces, face_prim = [], []
    prim_models, prim_normal_mats, prim_tex = [], [], []
    v_cursor = 0
    for pid, d in enumerate(draws):
        nv = d.positions.shape[0]
        positions.append(d.positions.astype(np.float32))
        normals.append(d.normals.astype(np.float32))
        uvs.append(d.uvs.astype(np.float32))
        vert_prim.append(np.full(nv, pid, dtype=np.int32))
        faces.append(d.indices.astype(np.int64).reshape(-1, 3).astype(np.int32) + v_cursor)
        face_prim.append(np.full(len(d.indices) // 3, pid, dtype=np.int32))
        prim_models.append(d.model_matrix.astype(np.float32))
        prim_normal_mats.append(d.normal_matrix.astype(np.float32))
        prim_tex.append(texture_id(d.image_uri))
        v_cursor += nv

    pos = np.concatenate(positions) if positions else np.zeros((0, 3), np.float32)
    nrm = np.concatenate(normals) if normals else np.zeros((0, 3), np.float32)
    uv = np.concatenate(uvs) if uvs else np.zeros((0, 2), np.float32)
    vp = np.concatenate(vert_prim) if vert_prim else np.zeros(0, np.int32)
    fc = np.concatenate(faces) if faces else np.zeros((0, 3), np.int32)
    fp = np.concatenate(face_prim) if face_prim else np.zeros(0, np.int32)

    n_faces = fc.shape[0]
    n_vertices = pos.shape[0]
    fpad = max(face_pad, _round_up(n_faces, face_pad))
    vpad = max(vert_pad, _round_up(n_vertices, vert_pad))

    faces_padded = _pad_to(fc, fpad)
    prim_tex_arr = np.asarray(prim_tex if prim_tex else [0], dtype=np.int32)
    face_prim_padded = _pad_to(fp, fpad)
    scene = DeviceScene(
        positions=_pad_to(pos, vpad),
        normals=_pad_to(nrm, vpad),
        uvs=_pad_to(uv, vpad),
        vert_prim=_pad_to(vp, vpad),
        faces=faces_padded,
        face_prim=face_prim_padded,
        n_faces=n_faces,
        n_vertices=n_vertices,
        models=np.stack(prim_models) if prim_models else np.eye(4, dtype=np.float32)[None],
        normal_mats=np.stack(prim_normal_mats) if prim_normal_mats else np.eye(3, dtype=np.float32)[None],
        prim_tex=prim_tex_arr,
        atlas=tex_mod.build_atlas(pyramids),
        texture_uris=texture_uris,
        pages=build_pages(pyramids),
        face_tex=prim_tex_arr[face_prim_padded],
    )
    scene.corner_tables()
    return scene


def _bf16_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array of 2-byte bfloat16 (ml_dtypes, as np.asarray of a jax
    bf16 array gives) as a torch bf16 tensor, by bit view: the port does
    not import ml_dtypes."""
    if a.dtype.itemsize != 2 or a.dtype.name != "bfloat16":
        raise TypeError(f"expected a bfloat16 array, got {a.dtype}")
    return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)


def _tensors(arrays: dict, page, texels, n_faces: int, device) -> dict:
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    atlas = {"offsets": t(arrays["offsets"]), "sizes": t(arrays["sizes"]), "n_mips": t(arrays["n_mips"])}
    if page is not None:
        # One resident copy, channel-interleaved for the sample kernel; every
        # reader holds its (4, PH, PW) view (kernels/sampler.py).
        atlas["page"] = interleave_page(page.to(dev))
        for k in ("page_origins", "page_sizes", "page_n_mips"):
            atlas[k] = t(arrays[k])
    if texels is not None:
        atlas["texels"] = texels.contiguous().to(dev)
        if texels.dtype == torch.uint8:
            # srgb8 rows: the shade kernels' RGB decode table, made once here.
            atlas["srgb_lut"] = srgb_table(dev)
    return {
        "corner_world": t(arrays["corner_world"]),
        "corner_normal": t(arrays["corner_normal"]),
        "corner_uv": t(arrays["corner_uv"]),
        "face_tex": t(arrays["face_tex"].astype(np.int32)),
        "n_faces": int(n_faces),
        "atlas": atlas,
    }


def upload(scene: DeviceScene, device, texture_dtype: str | None = None) -> dict:
    """The frame function's scene state as torch tensors on ``device``.

    The page is rounded to bf16 by torch (round to nearest even, bit for
    bit what ml_dtypes does for the reference's upload) and kept as one
    channel-interleaved (PH, PW, 4) array; atlas["page"] is its
    (4, PH, PW) view, which indexes like the reference's planar page. With
    texture_dtype ("float32", "float16", "bfloat16" or "srgb8") the atlas
    also carries the quad-row texels in that dtype (srgb8 rows with
    atlas["srgb_lut"], their decode table, kernels/shade.py::srgb_table);
    without it, it does not. A scene without pages uploads no page. Inside
    the ``setup.upload`` span (tracing.py)."""
    span = tracing.SETUP_UPLOAD.begin()
    try:
        return _upload(scene, device, texture_dtype)
    finally:
        tracing.SETUP_UPLOAD.end(span)


def _upload(scene: DeviceScene, device, texture_dtype: str | None) -> dict:
    cw, cn, cu = scene.corner_tables()
    face_tex = (
        scene.face_tex if scene.face_tex is not None else scene.prim_tex[scene.face_prim]
    )
    arrays = {
        "corner_world": cw,
        "corner_normal": cn,
        "corner_uv": cu,
        "face_tex": face_tex,
        "offsets": scene.atlas.offsets,
        "sizes": scene.atlas.sizes,
        "n_mips": scene.atlas.n_mips,
    }
    page = None
    if scene.pages is not None:
        arrays.update(
            page_origins=scene.pages.origins,
            page_sizes=scene.pages.sizes,
            page_n_mips=scene.pages.n_mips,
        )
        page = torch.from_numpy(scene.pages.planes).to(torch.bfloat16)
    texels = None if texture_dtype is None else texels_tensor(scene.atlas.texels, texture_dtype, device)
    return _tensors(arrays, page, texels, scene.n_faces, device)


def replicate(scene_dev: dict, device) -> dict:
    """A copy of the uploaded scene ``scene_dev`` on ``device`` (device to
    device copies; the mesh's replicated scene, the reference's
    in_specs=P()). The page is copied as its interleaved (PH, PW, 4) base
    and handed out as that copy's (4, PH, PW) view, the layout the sample
    kernel takes."""
    dev = torch.device(device)
    atlas = {}
    for k, v in scene_dev["atlas"].items():
        if k == "page":
            base = v.permute(1, 2, 0)
            if not base.is_contiguous():
                raise ValueError(f"replicate: the page is not the view of an interleaved page (strides {v.stride()})")
            atlas[k] = base.to(dev).permute(2, 0, 1)
        else:
            atlas[k] = v.to(dev)
    out = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in scene_dev.items() if k != "atlas"}
    out["atlas"] = atlas
    return out


def scene_bytes(scene_dev: dict) -> int:
    """Device bytes of an uploaded scene's tensors."""
    tensors = [v for v in scene_dev.values() if isinstance(v, torch.Tensor)] + list(scene_dev["atlas"].values())
    return sum(t.numel() * t.element_size() for t in tensors)


def _texels_from_numpy(a: np.ndarray) -> torch.Tensor:
    """The reference's uploaded texel rows (f32, f16, ml_dtypes bf16 or
    srgb8 u8) as a tensor of the same dtype."""
    if a.dtype.name == "bfloat16":
        return _bf16_from_numpy(a)
    return torch.from_numpy(np.array(a))


def from_numpy(tree: dict, device) -> dict:
    """``upload``'s result from the reference's DeviceScene.device() pytree,
    converted leaf by leaf with np.asarray (nested dicts kept). The texels
    and the page come along when the tree has them."""
    atlas = tree["atlas"]
    arrays = {
        "corner_world": tree["corner_world"],
        "corner_normal": tree["corner_normal"],
        "corner_uv": tree["corner_uv"],
        "face_tex": tree["face_tex"],
        "offsets": atlas["offsets"],
        "sizes": atlas["sizes"],
        "n_mips": atlas["n_mips"],
    }
    page = None
    if "page" in atlas:
        arrays.update({k: atlas[k] for k in ("page_origins", "page_sizes", "page_n_mips")})
        page = _bf16_from_numpy(atlas["page"])
    texels = _texels_from_numpy(atlas["texels"]) if "texels" in atlas else None
    return _tensors(arrays, page, texels, int(tree["n_faces"]), device)


def load_demo_scene(data_dir: str, include_porsche: bool = True) -> DeviceScene:
    """The reference's 4-model demo scene (tpurast/device/scene.py
    load_demo_scene, same placements). A mesh missing from data_dir is
    skipped with a log line; with none present the scene holds only the
    fallback texture."""
    up = math3d.WORLD_SPACE.up.vector()
    fwd = math3d.WORLD_SPACE.forward.vector()
    placements = [
        ("meshes/arena.glb", math3d.mat4_identity()),
        ("meshes/stanford_dragon.glb", math3d.translation(up * -1.0)),
        ("meshes/crate.glb", math3d.compose(math3d.scaling(0.4), math3d.translation(up * -1.4))),
    ]
    if include_porsche:
        placements.append(
            (
                "meshes/porche.glb",
                math3d.compose(
                    math3d.rotation_axis(np.deg2rad(90.0), up),
                    math3d.translation(fwd * 2.0 + up * -1.95),
                ),
            )
        )
    models = []
    for rel, post in placements:
        path = os.path.join(data_dir, rel)
        if not os.path.exists(path):
            log.warning("%s missing from data dir (stripped blob?) — skipped", rel)
            continue
        models.append(load_glb(path, post_transform=post))
    return build_scene(models, data_dir=data_dir)


def replicate_model(model: GltfModel, transforms: list[np.ndarray]) -> GltfModel:
    """Instancing: one draw record per instance transform
    (tpurast/device/scene.py replicate_model). Instances share the source
    arrays (no vertex copy on host); the flat scene build emits a primitive
    record per instance, so the corner tables treat instances like any
    other primitive."""
    draws = []
    for t in transforms:
        for d in model.draws:
            draws.append(
                dataclasses.replace(
                    d,
                    model_matrix=math3d.compose(d.model_matrix, t),
                    normal_matrix=math3d.normal_matrix(math3d.compose(d.model_matrix, t)),
                )
            )
    return GltfModel(draws=draws, image_uris=model.image_uris)


def load_instanced_dragons(data_dir: str, count: int = 64, spacing: float = 0.35) -> DeviceScene:
    """BASELINE config #4 scene: dragon x N in a grid (default 8x8)."""
    up = math3d.WORLD_SPACE.up.vector()
    dragon = load_glb(
        os.path.join(data_dir, "meshes/stanford_dragon.glb"),
        post_transform=math3d.translation(up * -1.0),
    )
    side = int(np.ceil(np.sqrt(count)))
    transforms = []
    for i in range(count):
        gx, gz = i % side, i // side
        offs = np.array(
            [(gx - (side - 1) / 2) * spacing, 0.0, (gz - (side - 1) / 2) * spacing],
            dtype=np.float32,
        )
        transforms.append(math3d.translation(offs))
    return build_scene([replicate_model(dragon, transforms)], data_dir=data_dir)


def _quad_draw(center, size_x, size_z, y, uv_scale, image_uri, normal_up=True) -> PrimitiveDraw:
    """Procedural textured floor/ceiling quad (world-space verts)."""
    hx, hz = size_x / 2, size_z / 2
    cx, cz = center
    positions = np.array(
        [
            [cx - hx, y, cz - hz],
            [cx + hx, y, cz - hz],
            [cx + hx, y, cz + hz],
            [cx - hx, y, cz + hz],
        ],
        dtype=np.float32,
    )
    n = np.array([0.0, -1.0 if normal_up else 1.0, 0.0], dtype=np.float32)
    # Winding: front-facing (CCW in y-down framebuffer coords) when seen
    # from the -Y (up) side.
    indices = np.array([0, 1, 2, 0, 2, 3] if normal_up else [0, 2, 1, 0, 3, 2], np.uint32)
    uvs = np.array([[0, 0], [uv_scale, 0], [uv_scale, uv_scale], [0, uv_scale]], np.float32)
    return PrimitiveDraw(
        positions=positions,
        normals=np.broadcast_to(n, (4, 3)).copy(),
        uvs=uvs,
        indices=indices,
        model_matrix=math3d.mat4_identity(),
        normal_matrix=np.eye(3, dtype=np.float32),
        image_uri=image_uri,
        material_name="procedural",
        node_name="quad",
    )


def load_hdr_scene(data_dir: str) -> DeviceScene:
    """BASELINE config #3: BC6H HDR base color + BC4u monochrome maps,
    full mip chains, trilinear.

    Geometry: two crates textured with the shipped BC6H assets
    (hdr_bc6u: true HDR radiances up to 65504; missing_bc6u: 8-mip
    chain) over a floor quad textured with a GENERATED BC4u KTX2 (written
    without zstd supercompression, so that the port needs no zstandard)."""
    up = math3d.WORLD_SPACE.up.vector()
    crate = load_glb(
        os.path.join(data_dir, "meshes/crate.glb"),
        post_transform=math3d.compose(math3d.scaling(0.4), math3d.translation(up * -1.4)),
    )
    crate_hdr = GltfModel(
        draws=[dataclasses.replace(d, image_uri="textures/hdr_bc6u.ktx2") for d in crate.draws],
        image_uris=["textures/hdr_bc6u.ktx2"],
    )
    crate2 = load_glb(
        os.path.join(data_dir, "meshes/crate.glb"),
        post_transform=math3d.compose(
            math3d.scaling(0.4), math3d.translation(up * -1.4 + np.array([1.0, 0, 0]))
        ),
    )
    crate_mips = GltfModel(
        draws=[dataclasses.replace(d, image_uri="textures/missing_bc6u.ktx2") for d in crate2.draws],
        image_uris=["textures/missing_bc6u.ktx2"],
    )
    # Generated BC4u stripes (full mip chain exercises trilinear).
    y, x = np.mgrid[0:256, 0:256]
    stripes = (((x // 8) % 2) * 220 + 20).astype(np.uint8)
    floor = GltfModel(
        draws=[_quad_draw((0.0, 0.0), 8.0, 8.0, 1.8, 8.0, "mem://bc4_stripes.ktx2")],
        image_uris=["mem://bc4_stripes.ktx2"],
    )
    return build_scene(
        [floor, crate_hdr, crate_mips],
        data_dir=data_dir,
        memory_assets={"mem://bc4_stripes.ktx2": bc4_blob(stripes)},
    )


def load_porsche_class_scene(data_dir: str, max_textures: int = 11) -> DeviceScene:
    """BASELINE config #2 stand-in: the reference's data directory ships
    the Porsche's BC7 textures without its mesh. This scene exercises the
    multi-material / high-res-texture path the Porsche would: dragons +
    crates, each draw bound to a different Porsche 2048x2048 BC7 texture
    (full mip chains), arena around them.

    When porche.glb is present, load_demo_scene picks it up instead.
    """
    uris = sorted(
        os.path.relpath(p, data_dir)
        for p in glob.glob(os.path.join(data_dir, "textures/porche/*.ktx2"))
    )[:max_textures]
    if not uris:
        raise FileNotFoundError("no porsche textures in data dir")

    arena = load_glb(os.path.join(data_dir, "meshes/arena.glb"))
    dragon = load_glb(os.path.join(data_dir, "meshes/stanford_dragon.glb"))
    crate = load_glb(os.path.join(data_dir, "meshes/crate.glb"))
    models = [arena]
    for i, uri in enumerate(uris):
        src = dragon if i % 2 == 0 else crate
        gx, gz = i % 4, i // 4
        post = math3d.compose(
            math3d.scaling(2.0 if src is dragon else 0.25),
            math3d.translation(
                np.array([(gx - 1.5) * 0.8, 1.0 if src is dragon else 1.25, (gz - 1.0) * 0.8], np.float32)
            ),
        )
        draws = [
            dataclasses.replace(
                d,
                image_uri=uri,
                model_matrix=math3d.compose(d.model_matrix, post),
                normal_matrix=math3d.normal_matrix(math3d.compose(d.model_matrix, post)),
            )
            for d in src.draws
        ]
        models.append(GltfModel(draws=draws, image_uris=[uri]))
    return build_scene(models, data_dir=data_dir)


# --------------------------------------------------------------------------
# Procedural scene (chip_smoke.py at full size; tests at a small one).


def texture_image(rng: np.random.Generator, size: int, index: int) -> np.ndarray:
    """(size, size) u8: a checker (cell 2^(2 + index % 4) texels) plus
    noise, so every mip level carries structure."""
    y, x = np.mgrid[0:size, 0:size]
    cell = 1 << (2 + index % 4)
    checker = ((x // cell + y // cell) % 2).astype(np.int32) * 150 + 50
    noise = rng.integers(-30, 31, (size, size))
    return np.clip(checker + noise, 0, 255).astype(np.uint8)


def bc4_blob(img: np.ndarray) -> bytes:
    """u8 image -> BC4 KTX2 with a full mip chain, without zstd
    supercompression (the port's host side needs no zstandard)."""
    from tpurast_torch.assets.ktx2 import VK_FORMAT_BC4_UNORM_BLOCK
    from tpurast_torch.assets.ktx2_write import encode_bc4, mip_chain_u8, write_ktx2

    payloads = [encode_bc4(m) for m in mip_chain_u8(img)]
    return write_ktx2(
        payloads, VK_FORMAT_BC4_UNORM_BLOCK, img.shape[1], img.shape[0], supercompress=False
    )


def _draw(positions, normals, uvs, tris, uri, name) -> PrimitiveDraw:
    return PrimitiveDraw(
        positions=positions.astype(np.float32),
        normals=normals.astype(np.float32),
        uvs=uvs.astype(np.float32),
        indices=tris.astype(np.uint32).reshape(-1),
        model_matrix=np.eye(4, dtype=np.float32),
        normal_matrix=np.eye(3, dtype=np.float32),
        image_uri=uri,
        material_name="procedural",
        node_name=name,
    )


def _floor_patch(x0, z0, size_x, size_z, nx, nz, uv_per_unit, uri) -> PrimitiveDraw:
    """nx x nz quads on the y=0 plane, front side toward -Y (world up)."""
    xs = np.linspace(x0, x0 + size_x, nx + 1, dtype=np.float64)
    zs = np.linspace(z0, z0 + size_z, nz + 1, dtype=np.float64)
    gz, gx = np.meshgrid(zs, xs, indexing="ij")  # (nz+1, nx+1)
    pos = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
    uv = (pos[:, [0, 2]] - [x0, z0]) * uv_per_unit
    nrm = np.broadcast_to(np.array([0.0, -1.0, 0.0]), pos.shape)
    i, j = np.meshgrid(np.arange(nz), np.arange(nx), indexing="ij")
    a = (i * (nx + 1) + j).reshape(-1)
    b, c, d = a + 1, a + nx + 2, a + nx + 1
    # Same winding as tpurast/device/scene.py _quad_draw (front from -Y).
    tris = np.stack([np.stack([a, b, c], 1), np.stack([a, c, d], 1)], 1)
    return _draw(pos, nrm, uv, tris, uri, "floor")


def _sphere(center, radius, rings, segments, uri) -> PrimitiveDraw:
    """UV sphere, triangles wound front-facing outward."""
    th = np.linspace(0.0, math.pi, rings + 1)
    ph = np.linspace(0.0, 2.0 * math.pi, segments + 1)
    t, p = np.meshgrid(th, ph, indexing="ij")
    nrm = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    pos = np.asarray(center) + radius * nrm
    uv = np.stack([2.0 * p / (2.0 * math.pi), t / math.pi], -1).reshape(-1, 2)
    tris = []
    for i in range(rings):
        for j in range(segments):
            a = i * (segments + 1) + j
            b, c, d = a + 1, a + segments + 2, a + segments + 1
            if i > 0:
                tris.append((a, b, c))
            if i < rings - 1:
                tris.append((a, c, d))
    tris = np.asarray(tris)
    # Orient each triangle so its geometric normal points outward: the
    # floor's convention, (b - a) x (c - a) toward the viewer is front.
    v = pos[tris]
    gn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    flip = np.einsum("ij,ij->i", gn, v.mean(axis=1) - center) < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return _draw(pos, nrm, uv, tris, uri, "sphere")


def build_orbit_scene(
    seed: int = 0,
    floor_quads: int = 256,
    spheres: int = 8,
    rings: int = 32,
    segments: int = 32,
    tex_size: int = 1024,
    n_textures: int = 8,
) -> DeviceScene:
    """The smoke scene: a 16x16-unit floor of floor_quads^2 quads in
    n_textures patches (uv repeat 16), a spheres x spheres grid of UV
    spheres, and n_textures generated tex_size^2 BC4 textures with full
    mip chains (plus the fallback texture, bound to every fourth sphere).
    At the defaults: 131,072 floor + 126,976 sphere triangles."""
    rng = np.random.default_rng(seed)
    assets = {f"mem://orbit_{i}.ktx2": bc4_blob(texture_image(rng, tex_size, i))
              for i in range(n_textures)}
    uris = list(assets)
    draws = []
    cols = max(1, n_textures // 2)
    rows = max(1, n_textures // cols)
    size = 16.0
    for k in range(cols * rows):
        cx, cz = k % cols, k // cols
        draws.append(
            _floor_patch(
                -size / 2 + cx * size / cols,
                -size / 2 + cz * size / rows,
                size / cols,
                size / rows,
                floor_quads // cols,
                floor_quads // rows,
                1.0,
                uris[k % len(uris)],
            )
        )
    spacing = 1.6
    radius = 0.5
    for k in range(spheres * spheres):
        gx, gz = k % spheres, k // spheres
        center = np.array(
            [(gx - (spheres - 1) / 2) * spacing, -radius - 0.05 * (k % 3),
             (gz - (spheres - 1) / 2) * spacing]
        )
        uri = None if k % 4 == 3 else uris[k % len(uris)]
        draws.append(_sphere(center, radius, rings, segments, uri))
    model = GltfModel(draws=draws, image_uris=uris)
    return build_scene([model], memory_assets=assets)


def orbit_track(n_frames: int = 8, radius: float = 11.5, height: float = 1.5) -> list[Camera]:
    """Cameras orbiting the scene `height` units above the floor (world up
    is -Y), aimed one unit below the floor's center so the floor fills the
    lower part of the frame: grazing floor pixels take up to 16 probes and
    the far floor reaches the last mips. The eye plane stays off the floor
    (it meets the floor plane 11.8 units from the center, beyond the 10.8
    the floor reaches in the track's directions): floor triangles crossing
    it would bin as full-screen faces and overflow the binner's huge-face
    budget."""
    return [orbit_camera(2.0 * math.pi * k / n_frames + 0.3, radius, height) for k in range(n_frames)]


def orbit_camera(angle: float, radius: float = 11.5, height: float = 1.5) -> Camera:
    """The camera of orbit_track at ``angle`` radians around the scene."""
    pos = np.array([radius * math.sin(angle), -height, -radius * math.cos(angle)], np.float32)
    return Camera.from_target(pos, np.array([0.0, 1.0, 0.0], np.float32))
