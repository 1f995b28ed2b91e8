"""3D math with the reference renderer's exact semantics (host-side numpy).

Conventions (SURVEY.md §2.4):

* Matrices here are standard numpy ``(4, 4)`` arrays acting on **column
  vectors**: ``v' = M @ v``. The reference stores ``Mat4 = [4]Vec4`` with
  ``mat[i]`` = column i (src/math.zig:77); its ``mat4Mul(a, b)`` computes the
  standard product ``B @ A`` — i.e. arguments read in *application order*
  (src/math.zig:180-200). We expose that reading as :func:`compose`:
  ``compose(m1, m2, m3) == m3 @ m2 @ m1`` (apply ``m1`` first).
* Reversed-Z, infinite far plane: :func:`perspective_inverse_depth` maps
  ``z_view == near`` to NDC depth 1 and ``z_view -> inf`` to 0
  (src/math.zig:280-300).
* ``look_at`` builds a +Z-forward view matrix (forward NOT negated,
  src/math.zig:257-278).
* Coordinate systems are named axis triples; the demo uses model space =
  glTF ``(right=-X, up=+Y, fwd=+Z)`` and world space = "vulkan"
  ``(right=+X, up=-Y, fwd=+Z)`` (src/Engine.zig:35-36, src/math.zig:41-55).

Everything is float32 and pure; these run on host at scene-build/frame-setup
time. The per-vertex/per-pixel math lives in :mod:`tpurast_torch.kernels`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

F32 = np.float32


# ---------------------------------------------------------------------------
# Coordinate systems
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Axis:
    """A world axis: index 0/1/2 for x/y/z plus a sign."""

    index: int
    sign: float

    def vector(self) -> np.ndarray:
        v = np.zeros(3, dtype=F32)
        v[self.index] = self.sign
        return v


@dataclasses.dataclass(frozen=True)
class CoordinateSystem:
    """Right/up/forward axis assignment (src/math.zig:14-68)."""

    right: Axis
    up: Axis
    forward: Axis


BLENDER = CoordinateSystem(Axis(0, +1), Axis(2, +1), Axis(1, +1))
VULKAN = CoordinateSystem(Axis(0, +1), Axis(1, -1), Axis(2, +1))
GLTF = CoordinateSystem(Axis(0, -1), Axis(1, +1), Axis(2, +1))

# The demo's spaces (src/Engine.zig:35-36).
MODEL_SPACE = GLTF
WORLD_SPACE = VULKAN


def coordinate_transform(source: CoordinateSystem, target: CoordinateSystem) -> np.ndarray:
    """Matrix mapping source-space direction vectors into target space.

    A vector's component along ``source.right`` becomes its component along
    ``target.right`` (scaled by the sign product), and likewise for up and
    forward (src/math.zig:57-67). For the demo's gltf->vulkan pair this is
    ``diag(-1, -1, 1, 1)``.
    """
    m = np.zeros((4, 4), dtype=F32)
    for src_axis, tgt_axis in (
        (source.right, target.right),
        (source.up, target.up),
        (source.forward, target.forward),
    ):
        m[tgt_axis.index, src_axis.index] = src_axis.sign * tgt_axis.sign
    m[3, 3] = 1.0
    return m


# ---------------------------------------------------------------------------
# Mat4 builders (column-vector convention; translate/rotate/scale return the
# standalone matrix — composition is explicit via compose()/@)
# ---------------------------------------------------------------------------


def mat4_identity() -> np.ndarray:
    return np.eye(4, dtype=F32)


def compose(*matrices: np.ndarray) -> np.ndarray:
    """Compose in application order: ``compose(a, b) @ v == b @ (a @ v)``.

    Mirrors the reference's ``mat4Mul(a, b) == B·A`` gotcha
    (src/math.zig:180-200, SURVEY.md §2.4.2) without inheriting the
    confusing call syntax.
    """
    out = mat4_identity()
    for m in matrices:
        out = np.asarray(m, dtype=F32) @ out
    return out


def translation(t) -> np.ndarray:
    m = mat4_identity()
    m[:3, 3] = np.asarray(t, dtype=F32)
    return m


def scaling(s) -> np.ndarray:
    s = np.asarray(s, dtype=F32)
    if s.ndim == 0:
        s = np.full(3, s, dtype=F32)
    m = mat4_identity()
    m[0, 0], m[1, 1], m[2, 2] = s[0], s[1], s[2]
    return m


def rotation_quat(q) -> np.ndarray:
    """Rotation matrix from glTF quaternion ``(x, y, z, w)``."""
    x, y, z, w = (F32(c) for c in np.asarray(q, dtype=F32))
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n > 0:
        x, y, z, w = x / n, y / n, z / n, w / n
    m = mat4_identity()
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y - z * w)
    m[0, 2] = 2 * (x * z + y * w)
    m[1, 0] = 2 * (x * y + z * w)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z - x * w)
    m[2, 0] = 2 * (x * z - y * w)
    m[2, 1] = 2 * (y * z + x * w)
    m[2, 2] = 1 - 2 * (x * x + y * y)
    return m


def rotation_axis(angle: float, axis) -> np.ndarray:
    """Rotation about an arbitrary (not necessarily unit) axis, like
    cglm's ``glmc_rotate`` (used at src/Engine.zig:132-139)."""
    axis = normalize(np.asarray(axis, dtype=F32))
    x, y, z = axis
    c, s = np.cos(F32(angle)), np.sin(F32(angle))
    t = 1 - c
    m = mat4_identity()
    m[:3, :3] = np.array(
        [
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
        ],
        dtype=F32,
    )
    return m


def trs(t, r_quat, s) -> np.ndarray:
    """glTF node TRS: scale first, then rotate, then translate
    (src/Renderer.zig:792-794 via cglm post-multiplication = T·R·S)."""
    return translation(t) @ rotation_quat(r_quat) @ scaling(s)


# ---------------------------------------------------------------------------
# Vectors
# ---------------------------------------------------------------------------


_EPS = np.finfo(np.float32).eps
#: The components of a x b: a[_NEXT] * b[_PREV] - a[_PREV] * b[_NEXT].
_NEXT, _PREV = np.array([1, 2, 0]), np.array([2, 0, 1])


def normalize(v: np.ndarray) -> np.ndarray:
    """Zero-safe normalize (src/math.zig:106-115 returns 0 for tiny norms)."""
    v = np.asarray(v, dtype=F32)
    n = np.sqrt(np.add.reduce(v * v, axis=None))
    if n < _EPS:
        return np.zeros_like(v)
    return v / n


def cross(a, b) -> np.ndarray:
    """np.cross of f32 vectors; two 3-vectors take the same f32 products
    and differences in three array operations, a fifth of np.cross's host
    time (a frame's view matrix makes two)."""
    a, b = np.asarray(a, dtype=F32), np.asarray(b, dtype=F32)
    if a.shape == b.shape == (3,):
        return a[_NEXT] * b[_PREV] - a[_PREV] * b[_NEXT]
    return np.cross(a, b)


def forward_from_euler(pitch: float, yaw: float) -> np.ndarray:
    """Pitch/yaw to forward direction: ``(cos p sin y, sin p, cos p cos y)``
    (src/math.zig:130-138; SURVEY.md §2.4.5)."""
    p, y = F32(pitch), F32(yaw)
    cos_p = np.cos(p)
    return normalize(np.array([cos_p * np.sin(y), np.sin(p), cos_p * np.cos(y)], dtype=F32))


# ---------------------------------------------------------------------------
# View / projection
# ---------------------------------------------------------------------------


def look_at(position, target, up) -> np.ndarray:
    """View matrix looking down +Z in view space (src/math.zig:257-278).

    Rows are right / local-up / forward; forward is **not** negated — view
    space is +Z-forward to pair with :func:`perspective_inverse_depth`.
    """
    position = np.asarray(position, dtype=F32)
    forward = normalize(np.asarray(target, dtype=F32) - position)
    right = normalize(cross(forward, np.asarray(up, dtype=F32)))
    local_up = cross(right, forward)

    m = mat4_identity()
    m[0, :3] = right
    m[1, :3] = local_up
    m[2, :3] = forward
    m[0, 3] = -np.dot(position, right)
    m[1, 3] = -np.dot(position, local_up)
    m[2, 3] = -np.dot(position, forward)
    return m


def perspective_inverse_depth(vfov: float, aspect: float, near: float) -> np.ndarray:
    """Reversed-Z infinite-far projection (src/math.zig:280-300).

    ``z_clip = near`` (constant) and ``w_clip = z_view``, so NDC depth =
    ``near / z_view``: 1 at the near plane, -> 0 at infinity. Pairs with
    depth compare GreaterEqual and depth clear 0.0.
    """
    focal = F32(1.0) / np.tan(F32(vfov) / 2)
    m = np.zeros((4, 4), dtype=F32)
    m[0, 0] = focal / F32(aspect)
    m[1, 1] = focal
    m[2, 3] = F32(near)
    m[3, 2] = 1.0
    return m


def normal_matrix(model: np.ndarray) -> np.ndarray:
    """Upper-left 3x3 of transpose(inverse(model)) (src/Renderer.zig:802)."""
    return np.linalg.inv(np.asarray(model, dtype=np.float64)).T[:3, :3].astype(F32)


def transform_point(m: np.ndarray, p) -> np.ndarray:
    v = m @ np.append(np.asarray(p, dtype=F32), F32(1.0))
    return v[:3] / v[3]


def transform_direction(m: np.ndarray, d) -> np.ndarray:
    return (m[:3, :3] @ np.asarray(d, dtype=F32)).astype(F32)
