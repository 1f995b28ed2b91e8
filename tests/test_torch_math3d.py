"""tpurast_torch.math3d's vector helpers against numpy's own forms and the
JAX package's math3d, bit for bit: the port's camera makes the same f32
view matrices as the reference whatever path its helpers take."""

import math

import numpy as np
import pytest

from tpurast import camera as ref_camera
from tpurast import math3d as ref_math3d
from tpurast_torch import camera, math3d


def bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def vectors(n: int, seed: int) -> np.ndarray:
    """n f32 3-vectors over magnitudes 1e-13 to 1e13, with zeros and signed
    zeros among them."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3)) * np.exp(rng.uniform(-30.0, 30.0, (n, 1)))
    v[rng.random((n, 3)) < 0.05] = 0.0
    v[rng.random((n, 3)) < 0.02] = -0.0
    return v.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_cross_of_two_vectors_is_np_cross(seed):
    a, b = vectors(2000, seed), vectors(2000, seed + 100)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(bits(math3d.cross(x, y)), bits(np.cross(x, y)))
    np.testing.assert_array_equal(bits(math3d.cross(a, b)), bits(np.cross(a, b)))
    assert math3d.cross([1, 0, 0], [0, 1, 0]).dtype == np.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_normalize_and_look_at_match_the_reference(seed):
    a, b = vectors(1000, seed), vectors(1000, seed + 100)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(bits(math3d.normalize(x)), bits(ref_math3d.normalize(x)))
        np.testing.assert_array_equal(bits(math3d.look_at(x, y, [0, -1, 0])),
                                      bits(ref_math3d.look_at(x, y, [0, -1, 0])))


def test_view_matrix_matches_the_reference_on_an_orbit():
    for k in range(628):
        a = 0.01 * k
        pos = np.array([2.5 * math.sin(a), 0.3 * math.cos(3 * a), -2.5 * math.cos(a)], np.float32)
        target = np.array([0.0, 0.1, 0.0], np.float32)
        got = camera.Camera.from_target(pos, target)
        want = ref_camera.Camera.from_target(pos, target)
        np.testing.assert_array_equal(bits(got.forward()), bits(want.forward()))
        np.testing.assert_array_equal(bits(got.view_matrix()), bits(want.view_matrix()))
