"""The stand-in data directory of the porsche-class scene, written from a seed.

A frozen copy of what tpurast_torch/tools/standin_data.py writes for the
porsche-class scene (``--stored``): the arena, the dragon-sized blob and
the crate as GLB meshes, and twelve 2048^2 BC7-sRGB textures with full
mip chains in stored Zstandard frames, under the reference's file names.
The reference's own data is not in the repository; this stands in for it
at BASELINE's sizes (BASELINE.md: 12 Porsche BC7-sRGB textures, 2048^2,
full mips; the port's tools write the 10 of them its mount held). Only the files the porsche-class scene reads are
written (``write_standin``); the instanced dragons' recipe writes the dragon alone (``dragon_glb``). ``small``
keeps the layout at the CPU tests' size.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import pathlib

import numpy as np

from portbench.scenes.encode import bc7_ktx2, write_glb

GENERATOR = "portbench.scenes.standin: a procedural stand-in, not the reference's data"
DRAGON_TEXTURE = "textures/stanford_dragon/stanford_dragon_diffuse_specular_bc7.ktx2"
CRATE_TEXTURE = "textures/crate/crate_diffuse_specular_bc7.ktx2"
N_PORSCHE = 12
MARKER = "PORTBENCH_STANDIN.json"

#: The dragon blob's latitude bands, segments and split vertices, and the
#: porsche textures' sizes, per scale.
SCALES = {
    "full": dict(bands=55, segments=179, splits=1597, porsche=[2048] * N_PORSCHE),
    "small": dict(bands=18, segments=60, splits=40, porsche=[64, 128, 256, 64, 128, 64, 128, 64, 256, 64, 128, 64]),
}


def _oriented(pos, tris, toward, inward: bool):
    v = pos[tris]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    out = np.einsum("ij,ij->i", n, v.mean(axis=1) - toward) >= 0
    flip = out == inward
    tris = tris.copy()
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return tris


def dragon_blob(bands: int, segments: int, splits: int, seed: int):
    """A closed lumpy blob with the dragon's triangle and vertex counts
    (full scale: 19,332 and 11,319), seams split as the original's charts.
    Returns positions, normals, uvs (V, 2) and triangles (F, 3)."""
    rng = np.random.default_rng(seed)
    rings = bands - 1
    th = np.linspace(0.0, math.pi, bands + 1)[1:-1]
    ph = 2.0 * math.pi * np.arange(segments) / segments
    t, p = np.meshgrid(th, ph, indexing="ij")
    a1, a2, a3 = rng.uniform(0.08, 0.16, 3)
    r = 1.0 + a1 * np.sin(3 * t) * np.cos(2 * p) + a2 * np.sin(5 * p + t) * np.sin(t) + a3 * np.cos(4 * t)
    unit = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1)
    grid = unit * r[..., None] * np.array([0.11, 0.08, 0.07])
    centre = np.array([0.0, -0.05, 0.0])
    poles = np.array([[0.0, 0.08 * (1 + a3), 0.0], [0.0, -0.08 * (1 + a3), 0.0]])
    base = np.concatenate([poles, grid.reshape(-1, 3)]) + centre

    def gv(i, j):
        return 2 + i * segments + j % segments

    step = max(1, segments // (splits // rings + 2))
    split_col = {}
    left = splits
    for j in range(1, segments, step):
        if left == 0:
            break
        split_col[j] = min(rings, left)
        left -= split_col[j]
    if left:
        raise ValueError(f"{splits} split vertices do not fit {segments} segments")
    verts = [(0, 0.5, 0.0), (1, 0.5, 2.0)] + [(gv(i, j), 4.0 * j / segments, 2.0 * (i + 1) / bands)
                                              for i in range(rings) for j in range(segments)]
    seam = {i: len(verts) + i for i in range(rings)}
    verts += [(gv(i, 0), 4.0, 2.0 * (i + 1) / bands) for i in range(rings)]
    copy = {}
    for j, n in split_col.items():
        for i in range(n):
            copy[i, j] = len(verts)
            verts.append(verts[gv(i, j)])

    def left_v(i, j):
        return copy.get((i, j), gv(i, j))

    def right_v(i, j):
        return seam[i] if j == segments else gv(i, j)

    tris = []
    for j in range(segments):
        tris.append((0, left_v(0, j), right_v(0, j + 1)))
        tris.append((1, left_v(rings - 1, j), right_v(rings - 1, j + 1)))
        for i in range(rings - 1):
            a, b = left_v(i, j), right_v(i, j + 1)
            c, d = left_v(i + 1, j), right_v(i + 1, j + 1)
            tris += [(a, b, d), (a, d, c)]
    geo = np.array([v[0] for v in verts])
    pos = base[geo]
    tris = _oriented(pos, np.array(tris, dtype=np.int64), centre, inward=False)
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]], pos[tris[:, 2]] - pos[tris[:, 0]])
    acc = np.zeros_like(base)
    np.add.at(acc, geo[tris].reshape(-1), np.repeat(fn, 3, axis=0))
    nrm = acc / np.linalg.norm(acc, axis=1, keepdims=True)
    uvs = np.array([(v[1], v[2]) for v in verts])
    return pos.astype(np.float32), nrm[geo].astype(np.float32), uvs.astype(np.float32), tris


def crate_mesh():
    """A cube of side 2 at the model origin: 24 vertices, 12 triangles."""
    pos, nrm, uvs, tris = [], [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            u_ax, v_ax = [k for k in range(3) if k != axis]
            k = len(pos)
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = n.copy()
                p[u_ax], p[v_ax] = du, dv
                pos.append(p)
                nrm.append(n)
                uvs.append(((du + 1) / 2, (dv + 1) / 2))
            tris += [(k, k + 1, k + 2), (k, k + 2, k + 3)]
    pos = np.array(pos)
    return pos, np.array(nrm), np.array(uvs), _oriented(pos, np.array(tris), np.zeros(3), inward=False)


def arena_mesh():
    """An open 8 x 8 box facing inward, floor at world y = 1.8: 10 triangles."""
    x, y0, y1 = 4.0, -1.8, 2.2
    floor = [(-x, y0, -x), (x, y0, -x), (x, y0, x), (-x, y0, x)]
    walls = []
    corners = [(-x, -x), (x, -x), (x, x), (-x, x)]
    for k in range(4):
        (ax, az), (bx, bz) = corners[k], corners[(k + 1) % 4]
        walls.append([(ax, y0, az), (bx, y0, bz), (bx, y1, bz), (ax, y1, az)])
    quads = [floor] + walls
    pos = np.array([p for q in quads for p in q])
    tris = np.array([(4 * k, 4 * k + 1, 4 * k + 2) for k in range(5)] + [(4 * k, 4 * k + 2, 4 * k + 3) for k in range(5)])
    tris = _oriented(pos, tris, np.array([0.0, 0.2, 0.0]), inward=True)
    v = pos[tris]
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm = np.zeros_like(pos)
    nrm[tris.reshape(-1)] = np.repeat(fn / np.linalg.norm(fn, axis=1, keepdims=True), 3, axis=0)
    uvs = np.stack([pos[:, 0] + pos[:, 1], pos[:, 2] + pos[:, 1]], -1) / 2.0
    return pos, nrm, uvs, tris


def ldr_image(rng: np.random.Generator, size: int, index: int) -> np.ndarray:
    """(size, size, 4) uint8: a tinted checker and stripes over seeded
    noise, alpha a smooth specular mask."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cell = 2 ** (3 + index % 4)
    checker = ((np.floor(x * cell) + np.floor(y * cell)) % 2) * 0.5 + 0.25
    stripes = 0.5 + 0.5 * np.sin(2 * math.pi * (x * (index + 2) + y * 3))
    hue = 2 * math.pi * index / N_PORSCHE
    tint = 0.5 + 0.5 * np.cos(hue + np.array([0.0, 2.1, 4.2]))
    rgb = (0.6 * checker + 0.4 * stripes)[..., None] * tint + 0.03 * rng.standard_normal((size, size, 3),
                                                                                        dtype=np.float32)
    alpha = 0.3 + 0.7 * (0.5 + 0.5 * np.cos(2 * math.pi * (x + y)))
    img = np.concatenate([rgb, alpha[..., None]], -1)
    return np.clip(np.rint(img * 255), 0, 255).astype(np.uint8)


def porsche_uris(scale: str) -> list[str]:
    return [f"textures/porche/standin_{i:02d}_bc7.ktx2" for i in range(len(SCALES[scale]["porsche"]))]


def write_marked(out_dir, want: dict, write) -> bool:
    """Call ``write(root)`` to fill ``out_dir``, unless the directory's
    marker already names ``want`` (the same generator, seed and scale); the
    marker is written last. Returns whether anything was written."""
    root = pathlib.Path(out_dir)
    marker = root / MARKER
    if marker.exists() and json.loads(marker.read_text()) == want:
        return False
    if marker.exists():
        marker.unlink()
    write(root)
    marker.write_text(json.dumps(want) + "\n")
    return True


def put(root: pathlib.Path, rel: str, blob: bytes) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(blob)


def dragon_glb(seed: int, scale: str) -> bytes:
    """meshes/stanford_dragon.glb: the blob at ``scale``, naming the
    dragon's texture."""
    cfg = SCALES[scale]
    return write_glb(*dragon_blob(cfg["bands"], cfg["segments"], cfg["splits"], seed),
                     image_uri=DRAGON_TEXTURE, generator=GENERATOR, name="stanford_dragon")


def write_standin(out_dir, seed: int, scale: str = "full") -> bool:
    """Write the porsche-class files for ``seed`` under ``out_dir``, unless
    the directory already holds them (its marker names the same seed and
    scale). Returns whether anything was written."""
    cfg = SCALES[scale]

    def write(root: pathlib.Path) -> None:
        put(root, "meshes/stanford_dragon.glb", dragon_glb(seed, scale))
        put(root, "meshes/crate.glb", write_glb(*crate_mesh(), image_uri=CRATE_TEXTURE, generator=GENERATOR,
                                                name="crate"))
        put(root, "meshes/arena.glb", write_glb(*arena_mesh(), image_uri=None, generator=GENERATOR, name="arena"))

        def texture(i: int) -> bytes:
            return bc7_ktx2(ldr_image(np.random.default_rng((seed, i)), cfg["porsche"][i], i))

        # numpy releases the GIL in the encoders' array work.
        with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            blobs = list(pool.map(texture, range(len(cfg["porsche"]))))
        for uri, blob in zip(porsche_uris(scale), blobs):
            put(root, uri, blob)

    return write_marked(out_dir, {"generator": GENERATOR, "seed": int(seed), "scale": scale}, write)
