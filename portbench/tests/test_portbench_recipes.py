"""Scene recipes found by name (portbench/recipes/): the lookup's rules, the
porsche-class recipe's files as they were before recipes were modules, and
the instanced dragons' reference scene and frame against the program's."""

from __future__ import annotations

import hashlib
import pathlib

import numpy as np
import pytest

from portbench import recipes, run, scenes, system
from portbench.reference import scene as rscene
from portbench.tests.conftest import TINY_FRAMES

CONFIGS = sorted((run.BENCH / "configs").glob("*.json"))
KINDS = sorted(p.stem for p in (run.BENCH / "recipes").glob("*.py") if p.stem != "__init__")
DRAGONS = {"kind": "standin_dragons64", "scale": "small", "count": 64, "spacing": 0.35}
NOT_KINDS = ["../x", "os.path", "__init__", "", "nope", "Standin_porsche_class", "standin_porsche_class.py",
             "standin_porsche_class/", None]
DISPATCHERS = {
    "scene_inputs": lambda kind, tmp: scenes.scene_inputs({"kind": kind}, 1, tmp),
    "program_scene": lambda kind, tmp: system.program_scene({"kind": kind, "data_dir": str(tmp)}),
    "from_inputs": lambda kind, tmp: rscene.from_inputs({"kind": kind, "data_dir": str(tmp)}),
}
#: sha256 over "<path> <sha256 of the file>" lines (sorted paths) of what the
#: porsche-class recipe wrote for seed 4242 at the small scale before recipes
#: were modules: the stand-in directory, marker included.
PORSCHE_SMALL_4242 = "5035c65c905c7a6b480a64679db4c318fff810042928224c251bc4c09d1d9420"


def _digests(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_every_configured_kind_resolves(path):
    kind = run.load_json(path)["scene"]["kind"]
    mod = recipes.module(kind)
    assert pathlib.Path(mod.__file__).resolve() == run.BENCH / "recipes" / f"{kind}.py"


@pytest.mark.parametrize("kind", KINDS)
def test_every_recipe_module_has_its_three_parts(kind):
    mod = recipes.module(kind)
    assert all(callable(getattr(mod, f)) for f in ("inputs", "program_loader", "reference_scene"))


@pytest.mark.parametrize("dispatcher", sorted(DISPATCHERS))
@pytest.mark.parametrize("kind", NOT_KINDS, ids=[repr(k) for k in NOT_KINDS])
def test_unknown_or_not_bare_kinds_raise(dispatcher, kind, tmp_path):
    with pytest.raises(ValueError, match="unknown scene recipe"):
        DISPATCHERS[dispatcher](kind, tmp_path)


@pytest.mark.parametrize("name", ["run.py", "system.py", "scenes/__init__.py", "reference/scene.py"])
def test_no_dispatcher_names_a_kind(name):
    text = (run.BENCH / name).read_text()
    assert KINDS and not [k for k in KINDS if k in text]


def test_porsche_recipe_writes_the_same_files_as_before(tmp_path):
    inputs = scenes.scene_inputs({"kind": "standin_porsche_class", "scale": "small", "textures": 12}, 4242, tmp_path)
    assert inputs == {"kind": "standin_porsche_class", "data_dir": str(tmp_path / "standin"), "textures": 12}
    assert [p.name for p in tmp_path.iterdir()] == ["standin"]
    digests = _digests(tmp_path)
    combined = hashlib.sha256("".join(f"{k} {v}\n" for k, v in sorted(digests.items())).encode()).hexdigest()
    assert combined == PORSCHE_SMALL_4242, digests


def test_dragons_recipe_writes_its_own_directory(tmp_path):
    inputs = scenes.scene_inputs(DRAGONS, 4242, tmp_path)
    assert inputs == {"kind": "standin_dragons64", "data_dir": str(tmp_path / "standin_dragons64"), "count": 64,
                      "spacing": 0.35}
    marker = tmp_path / "standin_dragons64" / "PORTBENCH_STANDIN.json"
    written = marker.stat().st_mtime_ns
    scenes.scene_inputs({"kind": "standin_porsche_class", "scale": "small", "textures": 12}, 4242, tmp_path)
    scenes.scene_inputs(DRAGONS, 4242, tmp_path)  # the same seed after another scene's: reused
    assert marker.stat().st_mtime_ns == written
    dragons, porsche = _digests(tmp_path / "standin_dragons64"), _digests(tmp_path / "standin")
    assert sorted(dragons) == ["PORTBENCH_STANDIN.json", "meshes/stanford_dragon.glb"]
    assert dragons["meshes/stanford_dragon.glb"] == porsche["meshes/stanford_dragon.glb"]  # the one frozen blob
    scenes.scene_inputs(DRAGONS, 4243, tmp_path)  # another seed: rewritten
    reseeded = _digests(tmp_path / "standin_dragons64")
    assert reseeded["meshes/stanford_dragon.glb"] != porsche["meshes/stanford_dragon.glb"]


def test_dragons_reference_scene_matches_the_programs_build(tmp_path):
    inputs = scenes.scene_inputs(DRAGONS, 4242, tmp_path)
    ps = system.program_scene(inputs)
    rs = rscene.from_inputs(inputs)
    assert rs.n_faces == ps.n_faces == 64 * 2_040
    assert np.array_equal(ps.corner_world, rs.corner_world) and np.array_equal(ps.corner_uv, rs.corner_uv)
    assert np.array_equal(ps.corner_normal, rs.corner_normal) and np.array_equal(ps.face_tex, rs.face_tex)
    assert not ps.face_tex.any()  # the dragon's texture is missing: every face takes the fallback
    assert len(rs.textures) == len(ps.atlas.n_mips) == 1 and ps.texture_uris == ["builtin://fallback-texture"]
    for lvl, m in enumerate(rs.textures[0]):
        oy, ox = ps.pages.origins[0, lvl] + 1
        page = ps.pages.planes[:, oy : oy + m.shape[0], ox : ox + m.shape[1]].transpose(1, 2, 0)
        assert np.array_equal(page, m), lvl


def test_dragons_frame_through_run_cell(tmp_path, monkeypatch):
    """A 2 x 2 grid (the plain raster takes about 30 s a frame at 64) seen
    from outside it, about an eighth of the frame covered."""
    monkeypatch.setattr(run, "CACHE", tmp_path)
    config = {"scene": dict(DRAGONS, count=4), "width": 128, "height": 64, "renderer": {}}
    traffic = {"loop": "render", "poses": 21, "renderer": {}, "limits": {"max_lsb": 1},
               "track": {"target": [0.0, 1.0, 0.0], "radius": 0.5, "y": 0.9, "angle0": 0.0, "step": 0.3}}
    res = run.run_cell(config, traffic, [], 5, 0.5, False, device="cpu", **TINY_FRAMES)
    assert res["compared"] == {"max_lsb": {"value": 0.0, "limit": 1}, "dropped_pair_frames": {"value": 0.0, "limit": 0}}
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("name", ["_build_scene", "build_scene", "load_nothing_of_that_name"])
def test_a_recipe_reaches_only_a_public_loader(name, monkeypatch, tmp_path):
    mod = recipes.module("standin_dragons64")
    monkeypatch.setattr(mod, "program_loader", lambda inputs: (name, [str(tmp_path)], {}))
    with pytest.raises(ValueError, match="names no loader"):
        system.program_scene({"kind": "standin_dragons64"})
