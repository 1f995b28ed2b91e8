"""The reference's scene: world-space face corners and texture pyramids.

Built from the benchmark's generated files alone (the stand-in data
directory), by the scene rules of the reference renderer: draws in order,
texture 0 the fallback and the others numbered in the order draws first
name them, a missing file bound to texture 0, every vertex taken to world space by its draw's model
matrix and normals by its inverse transpose, each face's corners
gathered. Faces are padded to a multiple of 256 and vertices to one of
128 with zeros, as the renderer pads them, so that face ids and the
float32 sums come out the same.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import os

import numpy as np

from portbench import recipes
from portbench.reference import assets
from portbench.reference import math3d as m3


@dataclasses.dataclass
class RefScene:
    corner_world: np.ndarray  # (Fp, 3, 3) f32
    corner_normal: np.ndarray  # (Fp, 3, 3) f32
    corner_uv: np.ndarray  # (Fp, 3, 2) f32
    face_tex: np.ndarray  # (Fp,) i32
    n_faces: int
    textures: list[list[np.ndarray]]  # per texture id, its (H, W, 4) f32 linear mips


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)]) if n > a.shape[0] else a


def assemble(draws: list[dict], texture_of) -> RefScene:
    """draws: dicts of positions, normals, uvs, indices, model (4, 4) f32,
    normal_mat (3, 3) f32 and image_uri; texture_of(uri) -> its mips, or
    None where the texture is missing."""
    textures = [assets.fallback_pyramid()]
    ids: dict[str, int] = {}

    def tex_id(uri):
        if uri is None:
            return 0
        if uri not in ids:
            mips = texture_of(uri)
            ids[uri] = 0 if mips is None else len(textures)
            if mips is not None:
                textures.append(mips)
        return ids[uri]

    pos, nrm, uv, vprim, faces, fprim, models, nmats, ptex = [], [], [], [], [], [], [], [], []
    cursor = 0
    for pid, d in enumerate(draws):
        nv = d["positions"].shape[0]
        pos.append(d["positions"].astype(np.float32))
        nrm.append(d["normals"].astype(np.float32))
        uv.append(d["uvs"].astype(np.float32))
        vprim.append(np.full(nv, pid, dtype=np.int32))
        faces.append(d["indices"].astype(np.int64).reshape(-1, 3).astype(np.int32) + cursor)
        fprim.append(np.full(len(d["indices"]) // 3, pid, dtype=np.int32))
        models.append(d["model"].astype(np.float32))
        nmats.append(d["normal_mat"].astype(np.float32))
        ptex.append(tex_id(d["image_uri"]))
        cursor += nv
    fc = np.concatenate(faces)
    n_faces, n_vertices = fc.shape[0], cursor
    fpad, vpad = max(256, _round_up(n_faces, 256)), max(128, _round_up(n_vertices, 128))
    positions = _pad(np.concatenate(pos), vpad)
    normals = _pad(np.concatenate(nrm), vpad)
    uvs = _pad(np.concatenate(uv), vpad)
    vert_prim = _pad(np.concatenate(vprim), vpad)
    fc = _pad(fc, fpad)
    face_prim = _pad(np.concatenate(fprim), fpad)
    m = np.stack(models)[vert_prim]
    ph = np.concatenate([positions, np.ones_like(positions[:, :1])], axis=1)
    world = np.einsum("vij,vj->vi", m, ph).astype(np.float32)[:, :3]
    wnormal = np.einsum("vij,vj->vi", np.stack(nmats)[vert_prim], normals).astype(np.float32)
    return RefScene(corner_world=world[fc], corner_normal=wnormal[fc], corner_uv=uvs[fc],
                    face_tex=np.asarray(ptex, dtype=np.int32)[face_prim], n_faces=n_faces, textures=textures)


def glb_draws(path: str, post=None) -> list[dict]:
    """A generated GLB's primitives with their model matrices: the glTF to
    world basis change, then ``post``."""
    with open(path, "rb") as f:
        prims = assets.read_glb(f.read())
    model = m3.compose(m3.compose(m3.identity(), m3.identity()), m3.MODEL_TO_WORLD,
                       m3.identity() if post is None else post)
    return [dict(p, model=model, normal_mat=m3.normal_matrix(model)) for p in prims]


def porsche_class(data_dir: str, max_textures: int) -> RefScene:
    """The porsche-class scene of a (stand-in) data directory: the arena,
    and the porsche textures in name order, each on a dragon (even) or a
    crate (odd) placed on a 4-wide grid, dragons at scale 2, crates 0.25."""
    folder = os.path.join(data_dir, "textures", "porche")
    uris = sorted(f"textures/porche/{n}" for n in os.listdir(folder) if n.endswith(".ktx2"))[:max_textures]
    dragon = glb_draws(os.path.join(data_dir, "meshes/stanford_dragon.glb"))
    crate = glb_draws(os.path.join(data_dir, "meshes/crate.glb"))
    draws = glb_draws(os.path.join(data_dir, "meshes/arena.glb"))
    for i, uri in enumerate(uris):
        is_dragon = i % 2 == 0
        gx, gz = i % 4, i // 4
        post = m3.compose(
            m3.scaling(2.0 if is_dragon else 0.25),
            m3.translation(np.array([(gx - 1.5) * 0.8, 1.0 if is_dragon else 1.25, (gz - 1.0) * 0.8], np.float32)),
        )
        for d in dragon if is_dragon else crate:
            model = m3.compose(d["model"], post)
            draws.append(dict(d, image_uri=uri, model=model, normal_mat=m3.normal_matrix(model)))

    def load(uri):
        with open(os.path.join(data_dir, uri), "rb") as f:
            return assets.texture_pyramid(f.read())

    # numpy releases the GIL in the decoders' array work: a texture a thread.
    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        pyramids = dict(zip(uris, pool.map(load, uris)))
    return assemble(draws, pyramids.get)


def instanced_dragons(data_dir: str, count: int, spacing: float) -> RefScene:
    """The dragon of a data directory drawn ``count`` times, row by row, on
    the smallest square grid that holds them, ``spacing`` apart in x and z
    and centred on the origin, each first moved one unit down (along the
    world's up taken negative). Its texture, where the directory lacks it,
    is the fallback."""
    side = math.isqrt(count - 1) + 1
    dragon = glb_draws(os.path.join(data_dir, "meshes/stanford_dragon.glb"), post=m3.translation(m3.WORLD_UP * -1))
    draws = []
    for i in range(count):
        row, col = divmod(i, side)
        offset = np.array([(col - (side - 1) / 2) * spacing, 0.0, (row - (side - 1) / 2) * spacing], np.float32)
        for d in dragon:
            model = m3.compose(d["model"], m3.translation(offset))
            draws.append(dict(d, model=model, normal_mat=m3.normal_matrix(model)))

    def load(uri):
        path = os.path.join(data_dir, uri)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return assets.texture_pyramid(f.read())

    return assemble(draws, load)


def from_inputs(inputs: dict) -> RefScene:
    """The reference's scene from portbench.scenes.scene_inputs' result, as
    its recipe (portbench/recipes/<kind>.py) assembles it."""
    return recipes.module(inputs["kind"]).reference_scene(inputs)
