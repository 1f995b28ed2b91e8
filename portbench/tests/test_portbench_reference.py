"""The reference against the program's plain path on tiny scenes, its decoders
against the program's, and the control: the reference one precision lower
must come out as not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import check, run, scenes, system
from portbench.reference import assets
from portbench.reference import render as rrender
from portbench.reference import scene as rscene
from portbench.scenes import encode, tracks

TRACK = run.load_json(run.BENCH / "traffic" / "viewer_orbit.json")["track"]
RECIPE = {"kind": "standin_porsche_class", "scale": "small", "textures": 12}
PATHS = [{}, {"shading": "deferred", "texture_dtype": "srgb8"}, {"shading": "deferred"}]
IDS = ["window", "deferred-srgb8", "deferred-f16"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    cache = tmp_path_factory.mktemp("cache")
    return scenes.scene_inputs(RECIPE, 4242, cache)


def test_bc7_decoder_matches_the_programs():
    from tpurast_torch.assets import bcdec

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (32, 48, 4), dtype=np.uint8)
    blocks = np.frombuffer(encode.encode_bc7_mode6(img), np.uint8).reshape(-1, 16)
    want = bcdec.assemble_blocks(bcdec.decode_bc7(blocks), 12, 8, 48, 32)
    assert np.array_equal(assets.decode_bc7_mode6(blocks.tobytes(), 48, 32), want)
    assert np.array_equal(assets.srgb_to_linear(img), bcdec.srgb_to_linear(img))


def test_reference_scene_matches_the_programs_build(inputs):
    ps = system.program_scene(inputs)
    rs = rscene.from_inputs(inputs)
    assert np.array_equal(ps.corner_world, rs.corner_world) and np.array_equal(ps.corner_uv, rs.corner_uv)
    assert np.array_equal(ps.corner_normal, rs.corner_normal) and np.array_equal(ps.face_tex, rs.face_tex)
    assert len(rs.textures) == len(ps.atlas.n_mips) == 1 + 12  # the fallback and every porsche texture
    for t, mips in enumerate(rs.textures):
        for lvl, m in enumerate(mips):
            oy, ox = ps.pages.origins[t, lvl] + 1
            page = ps.pages.planes[:, oy : oy + m.shape[0], ox : ox + m.shape[1]].transpose(1, 2, 0)
            assert np.array_equal(page, m), (t, lvl)


@pytest.mark.parametrize("fields", PATHS, ids=IDS)
def test_reference_matches_the_programs_plain_path(inputs, fields):
    renderer = system.renderer(system.program_scene(inputs), 128, 64, fields, "cpu")
    target = rrender.Target(width=128, height=64)
    poses = tracks.circle_track(TRACK, 628)
    picks = [0, 157, 470]
    cams = system.cameras([poses[k] for k in picks])
    got = [renderer.render(c)["color"] for c in cams]
    want, _ = check.reference_frames(inputs, fields, target, [poses[k] for k in picks], "cpu")
    numbers = check.compare(got, want)
    assert numbers["max_lsb"] <= 1


@pytest.mark.parametrize("fields", PATHS[:2], ids=IDS[:2])
def test_control_one_precision_lower_is_not_correct(inputs, fields):
    target = rrender.Target(width=128, height=64)
    poses = [tracks.circle_track(TRACK, 628)[k] for k in (0, 314)]
    want, _ = check.reference_frames(inputs, fields, target, poses, "cpu")
    lower, _ = check.reference_frames(inputs, fields, target, poses, "cpu", lower=True)
    numbers = check.compare(lower, want)
    assert not check.judge(numbers, {"max_lsb": 1})


def test_texel_store_lower_precision():
    x = torch.rand(1000, 4)
    assert torch.equal(rrender.texel_store(x, "page"), x.to(torch.bfloat16).float())
    assert (rrender.texel_store(x, "page", lower=True) - x).abs().max() > (rrender.texel_store(x, "page") - x).abs().max()
    s8 = rrender.texel_store(x, "srgb8")
    assert torch.equal(rrender.srgb8_decode(rrender.srgb8_encode(s8)), s8)  # codes round-trip
    assert (rrender.texel_store(x, "srgb8", lower=True) - s8).abs().max() > 0.01
