"""tpurast_torch raster (plain version of csrc/raster.cu) on the CPU.

Two kinds of check:
  * against the JAX reference's rasterize_visibility on the same setup
    and bins (random faces, seeded, and adversarial faces: sub-pixel
    slivers, vertices on pixel centres and tile borders, AABB edges on
    whole and half pixels, far off-screen faces with clamped anchors,
    faces crossing w = 0, and one tile holding thousands of pairs): face
    ids exact; depth within 5 ulp (largest measured: 4), because XLA:CPU
    contracts a*b+c into FMAs inside the interpret-mode Pallas kernel,
    while the port rounds every operation, on the CPU as in the CUDA
    kernel built with --fmad=false. The reference restricts each face to
    the 8-row groups its sub-block touches, the port to the face's pixel
    rectangle (its AABB widened by one pixel): equal face ids show that
    the rectangle loses no covered pixel;
  * the coverage and depth properties of tests/test_raster.py, replayed
    through the port: watertight shared edges, later draw wins equal
    depth, z-clip, and the eye-plane-crossing ray cast.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurast.kernels import geometry as ref_geometry
from tpurast.kernels import raster as ref_raster
from tpurast_torch.kernels import geometry, raster

W = H = 64
TILE_H, TILE_W = 8, 128
TILES_X, TILES_Y = 1, 8


def rasterize(clip_verts, width=W, height=H):
    """Clip-space triangles (3n, 4) through the port: (depth, fid, det)."""
    c = torch.from_numpy(np.asarray(clip_verts, np.float32).reshape(-1, 3, 4))
    n = c.shape[0]
    tx, ty = -(-width // TILE_W), -(-height // TILE_H)
    s = geometry.triangle_setup(c, None, n, width, height)
    b = geometry.bin_pairs(s["aabb"], s["valid"], tx, ty, TILE_W, TILE_H)
    vis = raster.rasterize_tiles(
        s["setup"], s["aabb"], b["pair_faces"], b["offsets"], tile_h=TILE_H, tile_w=TILE_W, tiles_x=tx, tiles_y=ty
    )
    return vis[0, :height, :width].numpy(), vis[1, :height, :width].numpy().astype(np.int32), s["det"].numpy()


def ndc_tri(p0, p1, p2, z=0.5, w=1.0):
    return np.array([[p[0] * w, p[1] * w, z * w, w] for p in (p0, p1, p2)], dtype=np.float32)


def screen_to_ndc(x, y):
    return (2.0 * x / W - 1.0, 1.0 - 2.0 * y / H)


def tri_covering_pixels(x0, y0, x1, y1, z=0.5):
    span = (x1 - x0) + (y1 - y0) + 100
    a = screen_to_ndc(x0 - span, y0 - span)
    b = screen_to_ndc(x0 - span, y1 + 3 * span)
    c = screen_to_ndc(x1 + 3 * span, y0 - span)
    return ndc_tri(a, b, c, z=z)


# ---------------------------------------------------------------------------
# Against the reference kernel.


@pytest.fixture(scope="module")
def random_frame():
    """200 small faces + 20 eye-plane crossers at 256x128, both packages."""
    rng = np.random.default_rng(21)
    w, h, tx, ty = 256, 128, 2, 16
    small = rng.uniform(-1, 1, (200, 1, 2)) + rng.uniform(-0.15, 0.15, (200, 3, 2))
    z = rng.uniform(0.05, 0.9, (200, 1, 1)).repeat(3, 1)
    wv = rng.uniform(0.5, 3.0, (200, 3, 1))
    clip_small = np.concatenate([small * wv, z * wv, wv], axis=-1)
    cross = rng.uniform(-3, 3, (20, 3, 2))
    wc = rng.uniform(-2, 4, (20, 3, 1))
    clip_cross = np.concatenate([cross, np.full((20, 3, 1), 0.01), wc], axis=-1)
    clip = np.concatenate([clip_small, clip_cross]).astype(np.float32)
    n = clip.shape[0]
    s_r = ref_geometry.triangle_setup(jnp.asarray(clip), None, n, w, h)
    b_r = ref_geometry.bin_pairs(s_r["aabb"], s_r["valid"], tx, ty, TILE_W, TILE_H)
    d_r, f_r, dropped = ref_raster.rasterize_visibility(
        b_r, s_r["setup"], tile_h=TILE_H, tile_w=TILE_W, tiles_x=tx, tiles_y=ty, segment_headroom=256
    )
    assert int(dropped) == 0
    s_p = geometry.triangle_setup(torch.from_numpy(clip), None, n, w, h)
    b_p = geometry.bin_pairs(s_p["aabb"], s_p["valid"], tx, ty, TILE_W, TILE_H)
    vis = raster.rasterize_tiles(
        s_p["setup"], s_p["aabb"], b_p["pair_faces"], b_p["offsets"], tile_h=TILE_H, tile_w=TILE_W, tiles_x=tx, tiles_y=ty
    )
    return np.asarray(d_r), np.asarray(f_r), vis[0].numpy(), vis[1].numpy().astype(np.int32)


def test_fid_matches_reference(random_frame):
    _, f_r, _, f_p = random_frame
    assert (f_r >= 0).sum() > 5000
    np.testing.assert_array_equal(f_p, f_r)


def depth_ulps(a, b) -> np.ndarray:
    """Distance in f32 ulps between depth images (depths are >= 0)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def test_depth_matches_reference(random_frame):
    d_r, f_r, d_p, _ = random_frame
    np.testing.assert_array_equal(d_p[f_r < 0], d_r[f_r < 0])
    # XLA:CPU FMA contraction in the reference's interpret mode (see the
    # module docstring); the port rounds every operation.
    assert (d_r >= 0).all() and depth_ulps(d_p, d_r).max() <= 5


def _screen_clip(px, z, w):
    """Screen-space corners (n, 3, 2) in pixels of an AW x AH frame, depth
    (n,) and w (n, 3) -> clip (n, 3, 4). With w a power of two and
    dyadic pixel coordinates the screen positions survive exactly."""
    ndc_x = 2.0 * px[..., 0] / AW - 1.0
    ndc_y = 1.0 - 2.0 * px[..., 1] / AH
    return np.stack([ndc_x * w, ndc_y * w, z[:, None] * w, w], -1).astype(np.float32)


AW, AH, A_TILES_X, A_TILES_Y = 256, 64, 2, 8


def adversarial_clip(case: str) -> np.ndarray:
    """Clip-space faces (n, 3, 4) for a 256x64 frame of 8x128 tiles."""
    rng = np.random.default_rng(ADVERSARIAL.index(case))
    if case == "slivers":  # thinner than a pixel, at any angle
        n = 300
        p0 = rng.uniform([0, 0], [AW, AH], (n, 2))
        ang = rng.uniform(0, 2 * np.pi, n)
        d = np.stack([np.cos(ang), np.sin(ang)], -1)
        length = rng.uniform(3, 60, (n, 1))
        width = rng.uniform(0.02, 0.6, (n, 1))
        nrm = np.stack([-d[:, 1], d[:, 0]], -1)
        px = np.stack([p0, p0 + d * length * 0.5 + nrm * width, p0 + d * length], 1)  # front-facing
        w = np.broadcast_to(rng.choice([0.5, 1.0, 2.0], (n, 1)), (n, 3))
    elif case == "pixel_centres":  # vertices on pixel centres and on tile borders
        n = 300
        base = rng.integers([0, 0], [AW, AH], (n, 1, 2)) + 0.5
        px = base + rng.integers(-5, 6, (n, 3, 2))
        border = rng.random((n, 3)) < 0.3
        px[..., 0] = np.where(border & (rng.random((n, 3)) < 0.5), 128.0, px[..., 0])
        px[..., 1] = np.where(border, np.round(px[..., 1] / 8) * 8, px[..., 1])
        w = np.ones((n, 3))
    elif case == "aabb_on_grid":  # AABB edges on whole and half pixels
        n = 300
        px = rng.integers([0, 0], [2 * AW, 2 * AH], (n, 1, 2)) / 2.0 + rng.integers(-12, 13, (n, 3, 2)) / 2.0
        w = np.full((n, 3), 2.0)
    elif case == "far_off_screen":  # anchors clamped to [-4W, 5W] x [-4H, 5H]
        n = 60
        far = rng.uniform(-1e5, 1e5, (n, 3, 2))
        far[: n // 2, 0] = rng.uniform([0, 0], [AW, AH], (n // 2, 2))  # one corner on screen
        px = far
        w = np.ones((n, 3))
    elif case == "w_crossing":  # eye-plane crossers behind and among small faces
        n = 30
        cross = np.concatenate([rng.uniform(-3, 3, (n, 3, 2)), np.full((n, 3, 1), 0.01),
                                rng.uniform(-2, 4, (n, 3, 1))], -1)
        small = _screen_clip(rng.uniform([0, 0], [AW, AH], (200, 1, 2)) + rng.uniform(-12, 12, (200, 3, 2)),
                             rng.uniform(0.05, 0.95, 200), np.ones((200, 3)))
        return np.concatenate([cross, small]).astype(np.float32)
    elif case == "dense_tile":  # thousands of pairs in tile (0, 0), more than a raster work unit
        n = 6000
        c = rng.uniform([0, 0], [128, 8], (n, 1, 2))
        px = c + rng.uniform(-1.5, 1.5, (n, 3, 2))
        w = np.ones((n, 3))
    else:
        raise ValueError(case)
    z = rng.uniform(0.05, 0.95, px.shape[0])
    return _screen_clip(px, z, w)


ADVERSARIAL = ["slivers", "pixel_centres", "aabb_on_grid", "far_off_screen", "w_crossing", "dense_tile"]


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_adversarial_faces_match_reference(case):
    clip = adversarial_clip(case)
    n = clip.shape[0]
    s_r = ref_geometry.triangle_setup(jnp.asarray(clip), None, n, AW, AH)
    b_r = ref_geometry.bin_pairs(s_r["aabb"], s_r["valid"], A_TILES_X, A_TILES_Y, TILE_W, TILE_H)
    d_r, f_r, dropped = ref_raster.rasterize_visibility(
        b_r, s_r["setup"], tile_h=TILE_H, tile_w=TILE_W, tiles_x=A_TILES_X, tiles_y=A_TILES_Y,
        segment_headroom=256,
    )
    assert int(dropped) == 0
    s_p = geometry.triangle_setup(torch.from_numpy(clip), None, n, AW, AH)
    b_p = geometry.bin_pairs(s_p["aabb"], s_p["valid"], A_TILES_X, A_TILES_Y, TILE_W, TILE_H)
    if case == "dense_tile":
        assert int(b_p["counts"][0]) > 8 * raster.UNIT_PAIRS
    vis = raster.rasterize_tiles(s_p["setup"], s_p["aabb"], b_p["pair_faces"], b_p["offsets"], tile_h=TILE_H,
                                 tile_w=TILE_W, tiles_x=A_TILES_X, tiles_y=A_TILES_Y)
    d_r, f_r = np.asarray(d_r), np.asarray(f_r)
    d_p, f_p = vis[0].numpy(), vis[1].numpy().astype(np.int32)
    assert (f_r >= 0).sum() > 200
    np.testing.assert_array_equal(f_p, f_r)
    np.testing.assert_array_equal(d_p[f_r < 0], d_r[f_r < 0])
    # Depth of faces crossing w = 0 is left out: their ez / ew cancels, and
    # the reference's FMA contraction moves it by far more than 5 ulp (face
    # ids still equal); the port's kernel and plain version agree on it bit
    # for bit on the card.
    crossing = (clip[..., 3] <= 0.0).any(axis=1)
    judged = (f_r >= 0) & ~crossing[np.maximum(f_r, 0)]
    assert judged.sum() > 200
    assert depth_ulps(d_p[judged], d_r[judged]).max() <= 5


# ---------------------------------------------------------------------------
# tests/test_raster.py properties through the port.


def test_full_screen_triangle_front():
    depth, fid, det = rasterize(tri_covering_pixels(0, 0, W, H))
    assert det[0] < 0
    assert (fid == 0).all()
    np.testing.assert_allclose(depth, 0.5, atol=1e-6)


def test_half_screen_exact_pixel_count():
    t = ndc_tri(screen_to_ndc(0, 0), screen_to_ndc(0, 64), screen_to_ndc(64, 0))
    _, fid, _ = rasterize(t)
    xs, ys = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    np.testing.assert_array_equal(fid == 0, (xs + 0.5 + ys + 0.5) < 64)


def test_shared_edge_watertight_no_double_cover():
    p00 = screen_to_ndc(5.3, 7.1)
    p10 = screen_to_ndc(55.7, 9.2)
    p11 = screen_to_ndc(58.2, 51.8)
    p01 = screen_to_ndc(3.9, 49.4)
    tris = []
    for t in (ndc_tri(p00, p01, p10), ndc_tri(p10, p01, p11)):
        if rasterize(t)[2][0] > 0:
            t = t[[0, 2, 1]]
        tris.append(t)
    cov1 = rasterize(tris[0])[1] == 0
    cov2 = rasterize(tris[1])[1] == 0
    assert not (cov1 & cov2).any()
    _, fid_both, _ = rasterize(np.concatenate(tris))
    np.testing.assert_array_equal(fid_both >= 0, cov1 | cov2)
    for y in range(12, 48):
        xs = np.nonzero(cov1[y] | cov2[y])[0]
        assert len(xs) > 0 and (np.diff(xs) == 1).all(), f"gap in row {y}"


def test_nearer_wins_reversed_z():
    far = tri_covering_pixels(0, 0, W, H, z=0.25)
    near = tri_covering_pixels(0, 0, W, H, z=0.75)
    depth, fid, _ = rasterize(np.concatenate([near, far]))
    assert (fid == 0).all()
    np.testing.assert_allclose(depth, 0.75, atol=1e-6)


def test_equal_depth_later_wins():
    a = tri_covering_pixels(0, 0, W, H, z=0.5)
    _, fid, _ = rasterize(np.concatenate([a, a.copy()]))
    assert (fid == 1).all()


def test_equal_depth_later_wins_across_sub_blocks():
    """The merge rule is max depth, ties to the max face id, whatever the
    order of the tile's bin. In one 32-row tile, the later face (17) sorts
    first (y-bucket 0), 16 filler faces follow (bucket 1) and the earlier
    face (0) comes last (bucket 2), so the reference's kernel sees the two
    coplanar faces in different 16-face sub-blocks and its merge keeps the
    later sub-block: face 0 on rows 18-31 (ROADMAP queue 3). The port keeps
    the later draw, as wgpu's GreaterEqual does."""
    s = screen_to_ndc
    late_top = ndc_tri(s(-200, 0.2), s(-200, 300), s(300, 0.2))
    early_low = ndc_tri(s(-200, 17.5), s(-200, 300), s(300, 17.5))
    filler = [ndc_tri(s(x, 9.2), s(x, 9.8), s(x + 0.6, 9.2), z=0.1) for x in np.linspace(2, 60, 16)]
    clip = torch.from_numpy(np.concatenate([early_low] + filler + [late_top]).reshape(-1, 3, 4))
    st = geometry.triangle_setup(clip, None, clip.shape[0], W, H)
    assert bool(st["valid"].all())
    b = geometry.bin_pairs(st["aabb"], st["valid"], 1, 2, TILE_W, 32)
    vis = raster.rasterize_tiles(st["setup"], st["aabb"], b["pair_faces"], b["offsets"], tile_h=32, tile_w=TILE_W, tiles_x=1, tiles_y=2)
    fid = vis[1, :H, :W].numpy()
    assert (fid[18:] == 17).all()


def test_z_outside_clip_volume_discarded():
    for z in (1.5, -0.5):
        _, fid, _ = rasterize(tri_covering_pixels(0, 0, W, H, z=z))
        assert (fid == -1).all()


def _ray_hits(view_verts, px, py):
    """Möller-Trumbore ray-triangle in view space (tests/test_raster.py)."""
    ndc_x = 2.0 * (px + 0.5) / W - 1.0
    ndc_y = 1.0 - 2.0 * (py + 0.5) / H
    d = np.array([ndc_x, ndc_y, 1.0])
    v0, v1, v2 = view_verts
    e1, e2 = v1 - v0, v2 - v0
    pvec = np.cross(d, e2)
    det = e1 @ pvec
    if abs(det) < 1e-12:
        return False, 0.0
    inv = 1.0 / det
    tvec = -v0
    u = (tvec @ pvec) * inv
    qvec = np.cross(tvec, e1)
    vv = (d @ qvec) * inv
    t = (e2 @ qvec) * inv
    return (0 <= u <= 1 and 0 <= vv <= 1 and u + vv <= 1 and t > 0), t


def test_near_crossing_triangle_matches_raycast():
    rng = np.random.default_rng(3)
    near = 0.01
    checked_crossing = 0
    for trial in range(60):
        vv = rng.uniform(-3, 3, size=(3, 3))
        vv[:, 2] = rng.uniform(-2, 4, size=3)
        clip = np.stack([vv[:, 0], vv[:, 1], np.full(3, near), vv[:, 2]], axis=1).astype(np.float32)
        depth, fid, det = rasterize(clip)
        if det[0] >= 0:
            continue
        cov = fid == 0
        if (vv[:, 2] < 0).any() and cov.any():
            checked_crossing += 1
        ys, xs = np.nonzero(cov)
        step = max(1, len(ys) // 50)
        for y, x in zip(ys[::step], xs[::step]):
            hit, t = _ray_hits(vv, x, y)
            assert hit, f"ghost coverage at {x},{y} (trial {trial})"
            np.testing.assert_allclose(depth[y, x], near / t, rtol=2e-2, atol=1e-4)
    assert checked_crossing >= 1


def test_fully_behind_not_drawn():
    vv = np.array([[0.5, 0.5, -1.0], [-0.5, 0.5, -2.0], [0.0, -0.5, -1.5]])
    clip = np.stack([vv[:, 0], vv[:, 1], np.full(3, 0.01), vv[:, 2]], axis=1).astype(np.float32)
    assert (rasterize(clip)[1] == -1).all()


def test_kernel_inputs_must_share_a_device():
    setup = torch.zeros((1, geometry.SETUP_WIDTH))
    with pytest.raises(ValueError, match="all be on the CPU or all on one CUDA device"):
        raster.rasterize_tiles(
            setup, torch.zeros((1, 4)), torch.zeros(1, dtype=torch.int32, device="meta"),
            torch.zeros(2, dtype=torch.int32),
            tile_h=TILE_H, tile_w=TILE_W, tiles_x=1, tiles_y=1,
        )
