"""Write a stand-in for the reference's data directory.

    python -m tpurast_torch.tools.standin_data DIR [--scale full|small] [--seed N] [--stored]

The reference's data directory (meshes/, textures/) is not part of the
repository and is not downloaded. This tool writes a directory laid out as
that one, under the same file names and in the same formats, filled with
procedural meshes and textures made from ``--seed`` at the sizes BASELINE.md
lists, so that the port's named-scene loaders (device/scene_cache.py), the
bench's ``--all`` and ``entry`` run unchanged on it. It is a stand-in, not
the reference's data: STANDIN.json at its root and every GLB's
``asset.generator`` say so. Where the real directory is in place, the same
loaders read it instead.

What it writes (``--scale full``; ``small`` keeps the layout with a dragon
of about 2,000 triangles and textures of 64^2-256^2 for the CPU tests):

  meshes/arena.glb            10 triangles: a floor and four walls, no texture
  meshes/stanford_dragon.glb  a closed lumpy blob with the dragon's 19,332
                              triangles and 11,319 vertices, about 0.2 units
                              across, centred near world (0, 0.05, 0); it
                              names the dragon's texture, which the reference's
                              mount lacks too (.MISSING_LARGE_BLOBS), so both
                              packages log the miss and bind texture 0
  meshes/crate.glb            12 triangles, a 2-unit cube, its BC7 texture
  textures/crate/crate_diffuse_specular_bc7.ktx2   512^2 BC7-sRGB, full mips
  textures/porche/*.ktx2      10 BC7-sRGB textures, 2048^2, full mips (the
                              mount holds 10 of the 12)
  textures/hdr_bc6u.ktx2      BC6H-ufloat 512^2, one mip, up to 65504
  textures/missing_bc6u.ktx2  BC6H-ufloat 128^2, 8 mips
  STANDIN.json                generator, seed, scale, file sizes

No porche.glb and no resources/: both are absent from the reference's
mount as well, so load_demo_scene skips the car and both packages take the
procedural fallback texture. Every KTX2 is supercompressed (scheme 2): with
the zstandard package where it is installed, as stored frames with
``--stored`` (which needs no package: the GPU machine).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import math
import os
import pathlib
import sys
import time

import numpy as np

from tpurast_torch.assets import ktx2
from tpurast_torch.assets.glb_write import write_glb
from tpurast_torch.assets.ktx2_write import encode_bc6h_mode3, encode_bc7_mode6, mip_chain_u8, write_ktx2
from tpurast_torch.device.textures import mip_chain

GENERATOR = "tpurast_torch.tools.standin_data: a procedural stand-in, not the reference's data"
DRAGON_TEXTURE = "textures/stanford_dragon/stanford_dragon_diffuse_specular_bc7.ktx2"
CRATE_TEXTURE = "textures/crate/crate_diffuse_specular_bc7.ktx2"
N_PORSCHE = 10

#: Per scale: the dragon blob's latitude bands, segments and split
#: vertices (full: 2 * 179 * 54 = 19,332 triangles, 2 + 54 * 179 + 54 +
#: 1,597 = 11,319 vertices), the porsche textures' sizes, the crate's,
#: the two BC6H textures'.
SCALES = {
    "full": dict(bands=55, segments=179, splits=1597, porsche=[2048] * N_PORSCHE, crate=512, hdr=512, mips_hdr=128),
    "small": dict(bands=18, segments=60, splits=40, porsche=[64, 128, 256, 64, 128, 64, 128, 64, 256, 64],
                  crate=64, hdr=64, mips_hdr=128),
}


def _oriented(pos: np.ndarray, tris: np.ndarray, toward: np.ndarray, inward: bool) -> np.ndarray:
    """Triangles wound so that (b - a) x (c - a), the front side, points
    away from ``toward`` (or toward it with ``inward``)."""
    v = pos[tris]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    out = np.einsum("ij,ij->i", n, v.mean(axis=1) - toward) >= 0
    flip = out == inward
    tris = tris.copy()
    tris[flip] = tris[flip][:, [0, 2, 1]]
    return tris


def dragon_blob(bands: int, segments: int, splits: int, seed: int):
    """A closed blob: a lumpy sphere of ``bands`` latitude bands and
    ``segments`` segments with one vertex at each pole, the u-seam's
    vertices doubled, and ``splits`` more vertices doubled along further
    meridians (a chart seam each: the same position, normal and uv, used by
    the triangles east of it). Positions in glTF model space (+Y up), so
    that the world centre is about (0, 0.05, 0). Returns positions,
    normals, uvs (V, 2) and triangle indices (F, 3)."""
    rng = np.random.default_rng(seed)
    rings = bands - 1  # interior latitude rings
    th = np.linspace(0.0, math.pi, bands + 1)[1:-1]  # (rings,)
    ph = 2.0 * math.pi * np.arange(segments) / segments
    t, p = np.meshgrid(th, ph, indexing="ij")
    a1, a2, a3 = rng.uniform(0.08, 0.16, 3)
    r = 1.0 + a1 * np.sin(3 * t) * np.cos(2 * p) + a2 * np.sin(5 * p + t) * np.sin(t) + a3 * np.cos(4 * t)
    unit = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1)
    grid = unit * r[..., None] * np.array([0.11, 0.08, 0.07])  # (rings, segments, 3)
    centre = np.array([0.0, -0.05, 0.0])  # world (0, 0.05, 0): world = diag(-1, -1, 1) model
    poles = np.array([[0.0, 0.08 * (1 + a3), 0.0], [0.0, -0.08 * (1 + a3), 0.0]])
    base = np.concatenate([poles, grid.reshape(-1, 3)]) + centre  # geometric vertices

    def gv(i, j):  # geometric vertex of ring i, column j (mod segments)
        return 2 + i * segments + j % segments

    # Split meridians: columns 1, 1 + step, ... take copies of their first
    # vertices until `splits` are placed.
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
    # Vertex records: (geometric index, u, v).
    verts = [(0, 0.5, 0.0), (1, 0.5, 2.0)] + [(gv(i, j), 4.0 * j / segments, 2.0 * (i + 1) / bands)
                                              for i in range(rings) for j in range(segments)]
    seam = {i: len(verts) + i for i in range(rings)}
    verts += [(gv(i, 0), 4.0, 2.0 * (i + 1) / bands) for i in range(rings)]
    copy = {}
    for j, n in split_col.items():
        for i in range(n):
            copy[i, j] = len(verts)
            verts.append(verts[gv(i, j)])

    def left_v(i, j):  # column j's triangles: their left edge
        return copy.get((i, j), gv(i, j))

    def right_v(i, j):  # the right edge of column j - 1's triangles
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
    # Area-weighted normals over the geometric vertices, shared by copies.
    fn = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]], pos[tris[:, 2]] - pos[tris[:, 0]])
    acc = np.zeros_like(base)
    np.add.at(acc, geo[tris].reshape(-1), np.repeat(fn, 3, axis=0))
    nrm = acc / np.linalg.norm(acc, axis=1, keepdims=True)
    uvs = np.array([(v[1], v[2]) for v in verts])
    return pos.astype(np.float32), nrm[geo].astype(np.float32), uvs.astype(np.float32), tris


def crate_mesh():
    """A cube of side 2 centred at the model origin: 24 vertices, 12
    triangles, each face's uvs over [0, 1]^2."""
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
    """An open box the scenes stand in: a floor at world y = 1.8 (where the
    crates rest) and four walls 4 units high, 8 x 8 units, 10 triangles,
    facing inward."""
    x, y0, y1 = 4.0, -1.8, 2.2  # model y (world y = -model y)
    floor = [(-x, y0, -x), (x, y0, -x), (x, y0, x), (-x, y0, x)]
    walls = []
    corners = [(-x, -x), (x, -x), (x, x), (-x, x)]
    for k in range(4):
        (ax, az), (bx, bz) = corners[k], corners[(k + 1) % 4]
        walls.append([(ax, y0, az), (bx, y0, bz), (bx, y1, bz), (ax, y1, az)])
    quads = [floor] + walls
    pos = np.array([p for q in quads for p in q])
    tris = np.array([(4 * k, 4 * k + 1, 4 * k + 2) for k in range(5)] + [(4 * k, 4 * k + 2, 4 * k + 3) for k in range(5)])
    centre = np.array([0.0, 0.2, 0.0])
    tris = _oriented(pos, tris, centre, inward=True)
    v = pos[tris]
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm = np.zeros_like(pos)
    nrm[tris.reshape(-1)] = np.repeat(fn / np.linalg.norm(fn, axis=1, keepdims=True), 3, axis=0)
    uvs = np.stack([pos[:, 0] + pos[:, 1], pos[:, 2] + pos[:, 1]], -1) / 2.0
    return pos, nrm, uvs, tris


def ldr_image(rng: np.random.Generator, size: int, index: int) -> np.ndarray:
    """(size, size, 4) u8 RGBA: a tinted checker and stripes over seeded
    noise, alpha a smooth specular mask."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cell = 2 ** (3 + index % 4)
    checker = ((np.floor(x * cell) + np.floor(y * cell)) % 2) * 0.5 + 0.25
    stripes = 0.5 + 0.5 * np.sin(2 * math.pi * (x * (index + 2) + y * 3))
    hue = 2 * math.pi * index / N_PORSCHE
    tint = 0.5 + 0.5 * np.cos(hue + np.array([0.0, 2.1, 4.2]))
    rgb = (0.6 * checker + 0.4 * stripes)[..., None] * tint + 0.03 * rng.standard_normal((size, size, 3), dtype=np.float32)
    alpha = 0.3 + 0.7 * (0.5 + 0.5 * np.cos(2 * math.pi * (x + y)))
    img = np.concatenate([rgb, alpha[..., None]], -1)
    return np.clip(np.rint(img * 255), 0, 255).astype(np.uint8)


def hdr_image(size: int, peak: bool) -> np.ndarray:
    """(size, size, 3) f32 radiance: a sky gradient from 0.05 to 8 and,
    with ``peak``, a sun disk whose centre reaches 65504."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    sky = 0.05 + 8.0 * (1 - y) ** 2
    img = np.stack([sky * 0.6, sky * 0.8, sky], -1) * (0.8 + 0.2 * np.cos(6 * math.pi * x))[..., None]
    if peak:
        r2 = (x - 0.7) ** 2 + (y - 0.25) ** 2
        img = img + (65504.0 * np.exp(-r2 / 0.002))[..., None]
    return np.minimum(img, 65504.0).astype(np.float32)


def bc7_ktx2(img: np.ndarray, stored: bool) -> bytes:
    payloads = [encode_bc7_mode6(m) for m in mip_chain_u8(img)]
    return write_ktx2(payloads, ktx2.VK_FORMAT_BC7_SRGB_BLOCK, img.shape[1], img.shape[0], stored=stored)


def bc6h_ktx2(img: np.ndarray, n_mips: int, stored: bool) -> bytes:
    payloads = [encode_bc6h_mode3(m) for m in mip_chain(img)[:n_mips]]
    return write_ktx2(payloads, ktx2.VK_FORMAT_BC6H_UFLOAT_BLOCK, img.shape[1], img.shape[0], stored=stored)


def write_standin(out_dir, scale: str = "full", seed: int = 0, stored: bool = False) -> dict:
    """Write the stand-in directory under ``out_dir``; returns its
    STANDIN.json record."""
    cfg = SCALES[scale]
    root = pathlib.Path(out_dir)
    files = {}

    def put(rel: str, blob: bytes) -> None:
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(blob)
        files[rel] = len(blob)

    blob = dragon_blob(cfg["bands"], cfg["segments"], cfg["splits"], seed)
    put("meshes/stanford_dragon.glb", write_glb(*blob, image_uri=DRAGON_TEXTURE, generator=GENERATOR,
                                                name="stanford_dragon"))
    put("meshes/crate.glb", write_glb(*crate_mesh(), image_uri=CRATE_TEXTURE, generator=GENERATOR, name="crate"))
    put("meshes/arena.glb", write_glb(*arena_mesh(), image_uri=None, generator=GENERATOR, name="arena"))
    # Each texture from a seed of its own: numpy releases the GIL in the
    # encoders' array work, so threads make them side by side.
    textures = {CRATE_TEXTURE: lambda: bc7_ktx2(ldr_image(np.random.default_rng((seed, N_PORSCHE)), cfg["crate"],
                                                          N_PORSCHE), stored)}
    for i, size in enumerate(cfg["porsche"]):
        textures[f"textures/porche/standin_{i:02d}_bc7.ktx2"] = functools.partial(
            lambda i, size: bc7_ktx2(ldr_image(np.random.default_rng((seed, i)), size, i), stored), i, size)
    textures["textures/hdr_bc6u.ktx2"] = lambda: bc6h_ktx2(hdr_image(cfg["hdr"], peak=True), 1, stored)
    textures["textures/missing_bc6u.ktx2"] = lambda: bc6h_ktx2(hdr_image(cfg["mips_hdr"], peak=False), 8, stored)
    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        blobs = list(pool.map(lambda make: make(), textures.values()))
    for rel, blob in zip(textures, blobs):
        put(rel, blob)
    record = {
        "generator": GENERATOR,
        "seed": seed,
        "scale": scale,
        "supercompression": "zstd stored frames" if stored else "zstd (zstandard package)",
        "note": "A procedural stand-in laid out as the reference's data directory, at BASELINE's sizes; it is "
                "not the reference's data. Meshes and textures are made from the seed.",
        "files": files,
    }
    (root / "STANDIN.json").write_text(json.dumps(record, indent=1) + "\n")
    return record


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--scale", choices=sorted(SCALES), default="full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stored", action="store_true", help="stored zstd frames (no zstandard package needed)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        record = write_standin(args.out_dir, args.scale, args.seed, args.stored)
    except ModuleNotFoundError as e:
        print(f"standin_data: {e}; pass --stored to write stored zstd frames", file=sys.stderr)
        return 2
    total = sum(record["files"].values())
    print(json.dumps({"out_dir": os.fspath(args.out_dir), "scale": args.scale, "seed": args.seed,
                      "files": len(record["files"]), "bytes": total,
                      "seconds": round(time.perf_counter() - t0, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
