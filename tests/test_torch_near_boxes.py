"""Near-plane boxes: faces cut by the eye plane binned by the box of the part
the raster can cover (tpurast_torch/kernels/geometry.py near_boxes; the
kernel's csrc/bin.cu near_box is held to it in tests/test_torch_csrc.py and
under ASan in tests/test_torch_memsafety.py).

The raster covers a pixel of a face only where the face's depth z / w there
lies in [0, 1] and w > 0, so a face cut by the eye plane covers nothing
outside the projection of its part at w >= z. The setup gives such a face the
whole screen for its box; the binners' near= input ranges it by the box of
its part on the plane w = NEAR_K * z, a little nearer the eye, widened. Held
here on the plain versions:

  * tests/test_torch_geometry.py's ~2k faces (250 around the eye plane) at
    512x256, the whole frame and a slab: the raster's depth and face-id
    planes are the same bits under the whole-screen rule (no near=, the
    huge-face budget lifted) and the tightened rule; the tightened pairs are
    a subset of the whole-screen ones, and the pairs they drop cover no pixel
    (rastered alone they leave the clear frame);
  * the instanced dragons (the stand-in's small dragon, 64 of them 0.35
    apart, 130,560 faces) at four poses of the bench's flythrough at
    512x288: the same, on the cut faces;
  * the rule face by face: other faces keep their boxes bit for bit, a face
    wholly behind the near plane names no tile, corners that are not finite,
    past NEAR_MAX, with z <= 0 or |w| past NEAR_RATIO * z keep the whole
    screen, an overflowing projection is clamped;
  * the face counts (cut faces that name a tile, huge faces) of both
    binners, and the frame record that carries them (tracing.CUT, HUGE).

Time on one worker: about 20 s.
"""

import numpy as np
import pytest
import torch
from test_torch_geometry import H, W, _random_faces, _view_proj
from test_torch_memsafety import near_faces

from tpurast_torch import math3d
from tpurast_torch.assets.glb_write import write_glb
from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import build_orbit_scene, load_instanced_dragons
from tpurast_torch.kernels import geometry, raster
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import standin_data

TILE_H, TILE_W = 32, 128


def _pairs(bins) -> set:
    n = int(bins["offsets"][-1])
    return set(zip(bins["pair_tiles"][:n].tolist(), bins["pair_faces"][:n].tolist()))


def _raster(setup, aabb, pairs, tiles_x, tiles_y, ty_base):
    """The plain raster of the (tile, face) pairs (a set), listed by tile."""
    pairs = sorted(pairs)
    faces = torch.tensor([f for _, f in pairs], dtype=torch.int32)
    counts = torch.bincount(torch.tensor([t for t, _ in pairs], dtype=torch.int64), minlength=tiles_x * tiles_y)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)]).to(torch.int32)
    return raster.rasterize_tiles_plain(setup, aabb, faces, offsets, tile_h=TILE_H, tile_w=TILE_W, tiles_x=tiles_x,
                                        tiles_y=tiles_y, tile_row_offset=ty_base)


def _check_both_rules(so, clip, width, height, tiles_y, ty_base=0) -> int:
    """The whole-screen rule against the tightened one on setup ``so``;
    returns the pairs the tightened rule drops."""
    f = so["aabb"].shape[0]
    tiles_x = -(-width // TILE_W)
    grid = (so["aabb"], so["valid"], tiles_x, tiles_y, TILE_W, TILE_H)
    whole = geometry.bin_pairs(*grid, huge_budget=f, ty_base=ty_base)
    tight = geometry.bin_pairs(*grid, huge_budget=f, ty_base=ty_base, near=(clip, width, height))
    assert int(whole["overflow"]) == int(tight["overflow"]) == 0
    kept, every = _pairs(tight), _pairs(whole)
    assert kept <= every
    frame = [_raster(so["setup"], so["aabb"], p, tiles_x, tiles_y, ty_base) for p in (every, kept)]
    assert torch.equal(frame[0], frame[1])
    dropped = every - kept
    clear = _raster(so["setup"], so["aabb"], set(), tiles_x, tiles_y, ty_base)
    assert torch.equal(_raster(so["setup"], so["aabb"], dropped, tiles_x, tiles_y, ty_base), clear)
    return len(dropped)


@pytest.fixture(scope="module")
def random_faces():
    corners = _random_faces()
    clip = geometry.transform_corners(torch.from_numpy(corners), torch.from_numpy(_view_proj()))
    return geometry.triangle_setup(clip, None, corners.shape[0], W, H), clip


@pytest.mark.parametrize("tiles_y,ty_base", [(H // TILE_H, 0), (3, 2)], ids=["frame", "slab"])
def test_tight_ranges_keep_every_covered_pixel(random_faces, tiles_y, ty_base):
    so, clip = random_faces
    _, _, cut = geometry.near_boxes(so["aabb"], so["valid"], clip, W, H)
    assert int(cut.sum()) > 50
    assert _check_both_rules(so, clip, W, H, tiles_y, ty_base) > 500


@pytest.fixture(scope="module")
def dragons(tmp_path_factory):
    """The instanced dragons on the stand-in's small dragon blob (its
    texture missing: the fallback binds)."""
    root = tmp_path_factory.mktemp("dragons")
    cfg = standin_data.SCALES["small"]
    (root / "meshes").mkdir()
    blob = standin_data.dragon_blob(cfg["bands"], cfg["segments"], cfg["splits"], 3)
    (root / "meshes" / "stanford_dragon.glb").write_bytes(
        write_glb(*blob, image_uri=standin_data.DRAGON_TEXTURE, generator=standin_data.GENERATOR,
                  name="stanford_dragon"))
    scene = load_instanced_dragons(str(root), 64, 0.35)
    return torch.from_numpy(scene.corner_tables()[0]), scene.n_faces


@pytest.mark.parametrize("pose", [0, 157, 314, 471])
def test_dragon_flythrough_cut_faces(dragons, pose):
    """The bench's flythrough (tpurast_torch/cli.py flythrough: radius 1.2,
    height 0.75, from 0.4 rad by 0.01 a frame, looking at (0, 0.95, 0))
    stands among the dragons: every pose cuts faces by the eye plane, and
    under both rules their raster is the same bits."""
    corners, n_faces = dragons
    width, height = 512, 288
    ang = 0.4 + 0.01 * pose
    cam = Camera.from_target(np.array([1.2 * np.sin(ang), 0.75, -1.2 * np.cos(ang)], np.float32), [0.0, 0.95, 0.0])
    vp = (math3d.perspective_inverse_depth(np.radians(80.0), width / height, 0.01) @ cam.view_matrix())
    clip = geometry.transform_corners(corners, torch.from_numpy(vp.astype(np.float32)))
    so = geometry.triangle_setup(clip, None, n_faces, width, height)
    _, _, cut = geometry.near_boxes(so["aabb"], so["valid"], clip, width, height)
    idx = torch.nonzero(cut)[:, 0]
    assert len(idx) > 50
    sub = {k: so[k][idx] for k in ("setup", "aabb", "valid")}
    assert _check_both_rules(sub, clip[idx].contiguous(), width, height, -(-height // TILE_H)) > 0


def test_near_box_rules_face_by_face():
    aabb, valid, clip = near_faces()
    box, keep, cut = geometry.near_boxes(aabb, valid, clip, 512, 256)
    assert torch.equal(box[~cut], aabb[~cut]) and torch.equal(keep[~cut], valid[~cut])
    full = torch.tensor([0.0, 0.0, 512.0, 256.0])
    tight = cut & ~(box == full).all(dim=1)
    assert int(tight.sum()) > 50 and bool(torch.isfinite(box).all())
    assert bool((box[tight].abs() <= geometry.NEAR_CLAMP * (1 + geometry.NEAR_SLOPE) + geometry.NEAR_PAD).all())
    crafted = slice(aabb.shape[0] - 15, None)  # near_faces' crafted faces, in its order
    c_cut, c_keep, c_box = cut[crafted], keep[crafted], box[crafted]
    assert c_cut.tolist() == [True] * 14 + [False]
    assert c_keep.tolist() == [False, True, True, False] + [True] * 11  # behind the near plane: no tile
    whole = (c_box == full).all(dim=1).tolist()
    assert whole[5:12] == [True] * 7  # NaN, infinite, past NEAR_MAX, z <= 0: the whole screen
    assert whole[13] and whole[14]  # |w| past NEAR_RATIO * z; the face in front, not cut
    assert not any(whole[1:3]) and not whole[4]
    assert c_box[12].abs().max() >= geometry.NEAR_CLAMP  # the overflowing projection, clamped


def test_face_counts(random_faces):
    so, clip = random_faces
    grid = (so["aabb"], so["valid"], W // TILE_W, H // TILE_H, TILE_W, TILE_H)
    near = (clip, W, H)
    box, keep, cut = geometry.near_boxes(so["aabb"], so["valid"], clip, W, H)
    tx0, ty0, tx1, ty1, named = geometry._tile_ranges(box, keep, *grid[2:])
    span = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    want = [int((named & cut).sum()), int((named & (span > geometry.TILES_PER_FACE)).sum())]
    assert want[0] > 20 and want[1] > geometry.HUGE_BUDGET
    for bins in (geometry.bin_pairs(*grid, near=near), geometry.bin_triangles(*grid, 16384, near=near)):
        assert [int(bins["cut_faces"]), int(bins["huge_faces"])] == want
        assert bins["cut_faces"].dtype == bins["huge_faces"].dtype == torch.int32
    for bins in (geometry.bin_pairs(*grid), geometry.bin_triangles(*grid, 16384)):
        assert "cut_faces" not in bins and "huge_faces" not in bins


def test_frame_record_carries_the_face_counts():
    """The Renderer's frame (near-plane boxes on its path) writes the
    binner's cut and huge face counts into its record, beside bin_overflow;
    a camera just above the procedural floor cuts its quads."""
    from tpurast_torch import tracing

    scene = build_orbit_scene(seed=1, floor_quads=8, spheres=1, rings=8, segments=8, tex_size=32, n_textures=2)
    r = Renderer(scene, RendererConfig(width=128, height=64), device="cpu")
    cam = Camera.from_target(np.array([2.0, -0.2, 2.0], np.float32), np.array([-3.0, -0.6, -3.0], np.float32))
    out = r.render(cam)
    vp, _ = r.frame_uniforms(cam)
    kw = r._frame_kwargs
    clip = geometry.transform_corners(r.scene["corner_world"], vp)
    so = geometry.triangle_setup(clip, None, r.scene["n_faces"], kw["width"], kw["height"])
    bins = geometry.bin_pairs(so["aabb"], so["valid"], r.tiles_x, r.tiles_y, kw["tile_w"], kw["tile_h"],
                              near=(clip, kw["width"], kw["height"]))
    rec = r.marks.records[r.marks.enqueued % r.marks.slots]
    assert int(rec[tracing.DONE]) == r.marks.enqueued
    assert (int(rec[tracing.CUT]), int(rec[tracing.HUGE])) == (int(bins["cut_faces"]), int(bins["huge_faces"]))
    assert int(rec[tracing.CUT]) > 0 and int(rec[tracing.OVERFLOW]) == int(out["bin_overflow"]) == 0
    frames = r.marks.frames()
    assert int(frames["cut"][-1]) == int(bins["cut_faces"]) and int(frames["huge"][-1]) == int(bins["huge_faces"])
