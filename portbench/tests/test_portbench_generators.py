"""The generated inputs: the same seed gives the same inputs, another seed
other textures on the same shapes, and every seed the same poses."""

from __future__ import annotations

import hashlib
import pathlib

import numpy as np

from portbench import run
from portbench.scenes import standin, tracks


def _digest(root: pathlib.Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and p.name != standin.MARKER}


def test_standin_is_a_function_of_its_seed(tmp_path):
    assert standin.write_standin(tmp_path / "a", 11, "small")
    assert not standin.write_standin(tmp_path / "a", 11, "small")  # the same seed: reused
    standin.write_standin(tmp_path / "b", 11, "small")
    standin.write_standin(tmp_path / "c", 12, "small")
    a, b, c = (_digest(tmp_path / n) for n in "abc")
    assert a == b and a.keys() == c.keys() and a != c
    assert standin.write_standin(tmp_path / "a", 12, "small")  # another seed: rewritten
    assert _digest(tmp_path / "a") == c


def test_full_standin_has_baseline_sizes():
    pos, _, _, tris = standin.dragon_blob(**{k: standin.SCALES["full"][k] for k in ("bands", "segments", "splits")},
                                          seed=3)
    assert tris.shape[0] == 19_332 and pos.shape[0] == 11_319
    assert standin.SCALES["full"]["porsche"] == [2048] * 12  # BASELINE.md: 12 Porsche textures
    assert len(standin.SCALES["small"]["porsche"]) == 12


def test_every_seed_visits_the_same_poses():
    track = run.load_json(run.BENCH / "traffic" / "viewer_orbit.json")["track"]
    poses = tracks.circle_track(track, 628)
    # The reference viewer's start pose: (0, 0, -2.5) looking along +Z.
    assert len(poses) == 628 and np.allclose(poses[0][0], [0.0, 0.0, -2.5])
    assert np.allclose(poses[0][1] - poses[0][0], [0.0, 0.0, 2.5])
    starts = {tracks.start_pose(s, 628) for s in (1, 2, 3, 2**31 + 5, 2**33)}
    assert all(0 <= s < 628 for s in starts) and len(starts) > 1
    assert tracks.start_pose(2**31 + 5, 628) == tracks.start_pose(2**31 + 5, 628)
