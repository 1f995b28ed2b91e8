"""Host 3D math of the reference renderer: float32 numpy, column vectors.

The reference renderer's conventions (its src/math.zig, src/Camera.zig):
world up (0, -1, 0); look_at looks down +Z; a reversed-Z projection with
an infinite far plane; compose() applies its arguments left to right.
Written out here so that the reference works out every matrix itself.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
WORLD_UP = np.array([0.0, -1.0, 0.0], dtype=F32)
# glTF model space (right -X, up +Y, forward +Z) to the world's (right +X, up -Y, forward +Z).
MODEL_TO_WORLD = np.diag(np.array([-1.0, -1.0, 1.0, 1.0], dtype=F32))


def identity() -> np.ndarray:
    return np.eye(4, dtype=F32)


def compose(*matrices) -> np.ndarray:
    """compose(a, b) @ v == b @ (a @ v)."""
    out = identity()
    for m in matrices:
        out = np.asarray(m, dtype=F32) @ out
    return out


def translation(t) -> np.ndarray:
    m = identity()
    m[:3, 3] = np.asarray(t, dtype=F32)
    return m


def scaling(s) -> np.ndarray:
    s = np.asarray(s, dtype=F32)
    if s.ndim == 0:
        s = np.full(3, s, dtype=F32)
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = s[0], s[1], s[2]
    return m


def normal_matrix(model: np.ndarray) -> np.ndarray:
    """Upper-left 3x3 of the inverse transpose."""
    return np.linalg.inv(np.asarray(model, dtype=np.float64)).T[:3, :3].astype(F32)


def normalize(v) -> np.ndarray:
    v = np.asarray(v, dtype=F32)
    n = np.sqrt(np.sum(v * v))
    if n < np.finfo(np.float32).eps:
        return np.zeros_like(v)
    return v / n


def cross(a, b) -> np.ndarray:
    return np.cross(np.asarray(a, dtype=F32), np.asarray(b, dtype=F32))


def look_at(position, target, up) -> np.ndarray:
    position = np.asarray(position, dtype=F32)
    forward = normalize(np.asarray(target, dtype=F32) - position)
    right = normalize(cross(forward, np.asarray(up, dtype=F32)))
    local_up = cross(right, forward)
    m = identity()
    m[0, :3] = right
    m[1, :3] = local_up
    m[2, :3] = forward
    m[0, 3] = -np.dot(position, right)
    m[1, 3] = -np.dot(position, local_up)
    m[2, 3] = -np.dot(position, forward)
    return m


def perspective_inverse_depth(vfov: float, aspect: float, near: float) -> np.ndarray:
    """z_clip = near, w_clip = z_view: NDC depth 1 at the near plane, 0 at infinity."""
    focal = F32(1.0) / np.tan(F32(vfov) / 2)
    m = np.zeros((4, 4), dtype=F32)
    m[0, 0] = focal / F32(aspect)
    m[1, 1] = focal
    m[2, 3] = F32(near)
    m[3, 2] = 1.0
    return m


def view_from_target(position, target) -> np.ndarray:
    """The view matrix of a camera placed at ``position`` looking at
    ``target``: its pitch and yaw as the camera keeps them, the forward
    vector rebuilt from them, then look_at with the world's up."""
    position = np.asarray(position, dtype=F32)
    direction = normalize(np.asarray(target, dtype=F32) - position)
    pitch, yaw = F32(float(np.arcsin(direction[1]))), F32(float(np.arctan2(direction[0], direction[2])))
    forward = normalize(np.array([np.cos(pitch) * np.sin(yaw), np.sin(pitch), np.cos(pitch) * np.cos(yaw)],
                                 dtype=F32))
    return look_at(position, position + forward, WORLD_UP)


def frame_uniforms(position, target, width: int, height: int, vfov: float, znear: float):
    """(view_proj (4, 4) f32, camera position (3,) f32) of one pose."""
    projection = perspective_inverse_depth(vfov, width / height, znear)
    view_proj = (projection @ view_from_target(position, target)).astype(F32)
    return view_proj, np.asarray(position, dtype=F32)
