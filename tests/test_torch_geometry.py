"""tpurast_torch geometry stage against the JAX reference (CPU).

transform_corners, triangle_setup and bin_pairs are torch ops in the port
and XLA ops in the reference. The same ~2k faces (made with numpy from a
seed: small on-screen faces, faces crossing the eye plane, off-screen
faces and more than HUGE_BUDGET huge faces) go through both. Everything
must match bit for bit: the port writes the adjugate's cross products as
the FMAs XLA:CPU compiles them to (tpurast_torch.kernels.geometry._cross).

At 2^21 + 320 faces, most of them invalid, both binners equal the
reference's exactly (the port's one sort key once held 21 bits of face
id and raised there).

bin_triangles (binning="scan") is held to the reference's on the whole
pair_faces array, offsets, counts and overflow, exactly: with room for
every pair, truncated at half the pairs, with more than HUGE_BUDGET huge
faces, on a slab (ty_base 2), and with the reference's face chunk below
the face count.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurast import math3d
from tpurast.camera import Camera
from tpurast.kernels import geometry as ref_geometry
from tpurast_torch.kernels import geometry

W, H = 512, 256
TILE_H, TILE_W = 32, 128
TILES_X, TILES_Y = W // TILE_W, H // TILE_H


def _random_faces(seed: int = 5) -> np.ndarray:
    """(F, 3, 3) world corners: 1400 small faces in front of the camera,
    250 huge ones, 250 around the eye plane and 148 far off screen."""
    rng = np.random.default_rng(seed)

    def tris(n, center_lo, center_hi, size):
        c = rng.uniform(center_lo, center_hi, (n, 1, 3))
        return c + rng.uniform(-size, size, (n, 3, 3))

    return np.concatenate(
        [
            tris(1400, [-3, -2, 1], [3, 2, 8], 0.4),
            tris(250, [-2, -1, 3], [2, 1, 6], 3.0),
            tris(250, [-2, -2, -0.5], [2, 2, 0.5], 1.5),
            tris(148, [40, -2, 2], [60, 2, 9], 0.5),
        ]
    ).astype(np.float32)


def _view_proj() -> np.ndarray:
    cam = Camera.from_target(np.zeros(3, np.float32), np.array([0.0, 0.0, 1.0], np.float32))
    proj = math3d.perspective_inverse_depth(np.radians(80.0), W / H, 0.01)
    return (proj @ cam.view_matrix()).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    corners = _random_faces()
    vp = _view_proj()
    n = corners.shape[0]
    clip_r = ref_geometry.transform_corners(jnp.asarray(corners), jnp.asarray(vp))
    s_r = ref_geometry.triangle_setup(clip_r, None, n, W, H)
    b_r = ref_geometry.bin_pairs(s_r["aabb"], s_r["valid"], TILES_X, TILES_Y, TILE_W, TILE_H)
    clip_p = geometry.transform_corners(torch.from_numpy(corners), torch.from_numpy(vp))
    s_p = geometry.triangle_setup(clip_p, None, n, W, H)
    b_p = geometry.bin_pairs(s_p["aabb"], s_p["valid"], TILES_X, TILES_Y, TILE_W, TILE_H)
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return {
        "clip": (np.asarray(clip_r), clip_p.numpy()),
        "setup": (as_np(s_r), {k: v.numpy() for k, v in s_p.items()}),
        "bins": (as_np(b_r), {k: v.numpy() for k, v in b_p.items()}),
    }


def test_fixture_covers_the_hard_cases(both):
    s_r, _ = both["setup"]
    b_r, _ = both["bins"]
    clip_r, _ = both["clip"]
    w = clip_r[..., 3]
    assert ((w <= 0).any(axis=1) & (w > 0).any(axis=1)).sum() > 50, "eye-plane crossers"
    assert s_r["valid"].sum() > 400
    assert int(b_r["overflow"]) > 0, "more huge faces than HUGE_BUDGET must overflow"


def test_transform_corners_exact(both):
    ref, port = both["clip"]
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("field", ["setup", "valid", "aabb", "det"])
def test_triangle_setup_exact(both, field):
    ref, port = both["setup"]
    np.testing.assert_array_equal(port[field], ref[field])


@pytest.mark.parametrize("field", ["offsets", "counts", "overflow"])
def test_bin_pairs_exact(both, field):
    ref, port = both["bins"]
    np.testing.assert_array_equal(port[field], ref[field])


def test_bin_pairs_tile_lists_exact(both):
    """Per-tile face lists in the same (y-bucket, face) order; only the
    live prefix [0, offsets[-1]) of the static pair buffer is defined."""
    ref, port = both["bins"]
    n = int(ref["offsets"][-1])
    assert n > 0
    np.testing.assert_array_equal(port["pair_faces"][:n], ref["pair_faces"][:n])
    np.testing.assert_array_equal(port["pair_tiles"][:n], ref["pair_tiles"][:n])


def test_bin_pairs_rejects_faces_beyond_the_sort_key():
    """The face field holds any int32 id; what can overflow is the tile key
    above it: tiles * YB must stay under 2^TILE_KEY_BITS."""
    aabb = torch.zeros((1, 4))
    valid = torch.zeros(1, dtype=torch.bool)
    tiles = (1 << geometry.TILE_KEY_BITS) // geometry.YB
    for binner in (geometry.bin_pairs, functools.partial(geometry.bin_triangles, pair_capacity=16)):
        with pytest.raises(ValueError, match="sort-key"):
            binner(aabb, valid, tiles // 2, 2, TILE_W, TILE_H)
        assert int(binner(aabb, valid, tiles // 2, 1, TILE_W, TILE_H)["offsets"][-1]) == 0


MANY_FACES = (1 << 21) + 320


def _many_faces():
    """MANY_FACES AABBs (more than the 2^21 ids the port's sort key once
    held), nearly all invalid; 300 valid faces, all but 30 with ids above
    2^21, across the grid and past its edges. Every tenth face is huge
    (more tiles than TILES_PER_FACE), three of them below 2^21, so the
    huge round's draw order crosses the old field's edge."""
    rng = np.random.default_rng(21)
    aabb = np.zeros((MANY_FACES, 4), np.float32)
    valid = np.zeros(MANY_FACES, bool)
    high = (1 << 21) + rng.choice(MANY_FACES - (1 << 21), 270, replace=False)
    low = rng.choice(1 << 21, 30, replace=False)
    ids = np.concatenate([high, low])
    x0 = rng.uniform(-20, W, ids.size)
    y0 = rng.uniform(-10, H, ids.size)
    size = np.where(np.arange(ids.size) % 10 == 0, rng.uniform(200, 400, ids.size), rng.uniform(1, 90, ids.size))
    aabb[ids] = np.stack([x0, y0, x0 + size, y0 + size * 0.5], axis=1)
    valid[ids] = True
    return aabb, valid


@pytest.fixture(scope="module")
def many_faces_bins():
    aabb, valid = _many_faces()
    grid = (TILES_X, TILES_Y, TILE_W, TILE_H)
    cap = 4096
    ref = {"pairs": ref_geometry.bin_pairs(jnp.asarray(aabb), jnp.asarray(valid), *grid),
           "scan": ref_geometry.bin_triangles(jnp.asarray(aabb), jnp.asarray(valid), *grid, cap,
                                              face_chunk=1 << 18)}
    port = {"pairs": geometry.bin_pairs(torch.from_numpy(aabb), torch.from_numpy(valid), *grid),
            "scan": geometry.bin_triangles(torch.from_numpy(aabb), torch.from_numpy(valid), *grid, cap)}
    return ({k: {f: np.asarray(v) for f, v in d.items()} for k, d in ref.items()},
            {k: {f: v.numpy() for f, v in d.items()} for k, d in port.items()})


@pytest.mark.parametrize("binner", ["pairs", "scan"])
def test_binning_past_two_to_the_21_faces_matches_reference(many_faces_bins, binner):
    """Both binners at 2^21 + 320 faces equal the reference's exactly:
    offsets, counts, the live pair faces (and tiles) and overflow. The
    port's binners raised here while the face field was 21 bits wide."""
    ref, port = (side[binner] for side in many_faces_bins)
    n = int(ref["offsets"][-1])
    assert n > 300 and (ref["pair_faces"][:n] >= 1 << 21).sum() > n // 2
    assert int(ref["overflow"]) == 0
    for k in ("offsets", "counts", "overflow"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(port["pair_faces"][:n], ref["pair_faces"][:n])
    if binner == "pairs":
        np.testing.assert_array_equal(port["pair_tiles"][:n], ref["pair_tiles"][:n])
    else:
        np.testing.assert_array_equal(port["pair_faces"], ref["pair_faces"])


# (faces used, pair capacity or None for half the pairs, tiles_y, ty_base, reference face_chunk)
SCAN_CASES = {
    "fits": (1400, 16384, TILES_Y, 0, 8192),
    "truncated": (1400, None, TILES_Y, 0, 8192),
    "over_huge_budget": (None, 16384, TILES_Y, 0, 8192),
    "slab": (None, 4096, 3, 2, 8192),
    "face_chunks": (None, 8192, TILES_Y, 0, 300),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_bin_triangles_exact(case):
    n_faces, cap, tiles_y, ty_base, chunk = SCAN_CASES[case]
    corners = _random_faces()[:n_faces]
    n = corners.shape[0]
    vp = _view_proj()
    s_r = ref_geometry.triangle_setup(ref_geometry.transform_corners(jnp.asarray(corners), jnp.asarray(vp)),
                                      None, n, W, H)
    s_p = geometry.triangle_setup(geometry.transform_corners(torch.from_numpy(corners), torch.from_numpy(vp)),
                                  None, n, W, H)
    grid = (TILES_X, tiles_y, TILE_W, TILE_H)
    if cap is None:  # half of what the pair binner finds
        cap = int(geometry.bin_pairs(s_p["aabb"], s_p["valid"], *grid)["offsets"][-1]) // 2
    ref = ref_geometry.bin_triangles(s_r["aabb"], s_r["valid"], *grid, cap, ty_base=ty_base, face_chunk=chunk)
    port = geometry.bin_triangles(s_p["aabb"], s_p["valid"], *grid, cap, ty_base=ty_base, face_chunk=chunk)
    assert set(port) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert port["pair_faces"].shape == (cap,) and int(port["offsets"][-1]) > 100
    pairs = geometry.bin_pairs(s_p["aabb"], s_p["valid"], *grid, ty_base=ty_base)
    truncated = max(int(pairs["offsets"][-1]) - cap, 0)
    assert int(port["overflow"]) == int(pairs["overflow"]) + truncated
    assert (truncated > 0) == (case == "truncated")
    assert (int(pairs["overflow"]) > 0) == (n_faces is None), "more huge faces than HUGE_BUDGET overflow"
    if not truncated:  # the same tiles and the same face set per tile, in draw order
        np.testing.assert_array_equal(port["offsets"].numpy(), pairs["offsets"].numpy())
        for t in range(TILES_X * tiles_y):
            a, b = (int(x) for x in port["offsets"][t : t + 2])
            faces = port["pair_faces"][a:b]
            assert torch.equal(faces, torch.sort(pairs["pair_faces"][a:b]).values)
