"""Euler pitch/yaw fly camera with the reference's exact behavior.

Mirrors src/Camera.zig: init from position+target (:53-66); movement at
2.0 units/s with opposite-key cancellation (:26-45, :68-100); mouse
sensitivity 0.002, pitch clamped to +/-(pi/2 - 0.01), yaw wrapped to
[0, 2pi) (:102-112); view matrix via look_at with the world up vector
(:114-123). World up is ``(0, -1, 0)`` ("vulkan" space, src/Engine.zig:36).

Pure-functional: `Camera` is an immutable dataclass; update functions return
new cameras. The engine owns the mutable loop state.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from tpurast_torch import math3d

MOVE_SPEED = 2.0  # src/Camera.zig:73
MOUSE_SENSITIVITY = 0.002  # src/Camera.zig:103
PITCH_LIMIT = 0.5 * math.pi - 0.01  # src/Camera.zig:105


@dataclasses.dataclass(frozen=True)
class MoveDirection:
    """Key state; opposite keys cancel (src/Camera.zig:26-45)."""

    forward: bool = False
    backward: bool = False
    left: bool = False
    right: bool = False
    up: bool = False
    down: bool = False

    def normalized(self) -> "MoveDirection":
        d = self
        if d.forward and d.backward:
            d = dataclasses.replace(d, forward=False, backward=False)
        if d.left and d.right:
            d = dataclasses.replace(d, left=False, right=False)
        if d.up and d.down:
            d = dataclasses.replace(d, up=False, down=False)
        return d


@dataclasses.dataclass(frozen=True)
class Camera:
    position: np.ndarray  # (3,) f32
    pitch: float
    yaw: float

    @staticmethod
    def from_target(position, target) -> "Camera":
        """src/Camera.zig:53-66: pitch = asin(dir.y), yaw = atan2(dir.x, dir.z)."""
        position = np.asarray(position, dtype=np.float32)
        direction = math3d.normalize(np.asarray(target, dtype=np.float32) - position)
        return Camera(
            position=position,
            pitch=float(np.arcsin(direction[1])),
            yaw=float(np.arctan2(direction[0], direction[2])),
        )

    def forward(self) -> np.ndarray:
        return math3d.forward_from_euler(self.pitch, self.yaw)

    def translate(
        self,
        delta_time: float,
        move: MoveDirection,
        world_up: np.ndarray | None = None,
    ) -> "Camera":
        """src/Camera.zig:68-100. ``world_up`` defaults to the demo world's
        up vector (0, -1, 0)."""
        if world_up is None:
            world_up = math3d.WORLD_SPACE.up.vector()
        move = move.normalized()
        forward = self.forward()
        amount = np.float32(delta_time * MOVE_SPEED)
        position = self.position.astype(np.float32).copy()

        if move.forward:
            position += forward * amount
        elif move.backward:
            position -= forward * amount

        right = math3d.normalize(math3d.cross(forward, world_up))
        if move.left:
            position -= right * amount
        elif move.right:
            position += right * amount

        if move.up:
            position += world_up * amount
        elif move.down:
            position -= world_up * amount

        return dataclasses.replace(self, position=position)

    def update_orientation(self, delta_x: float, delta_y: float) -> "Camera":
        """src/Camera.zig:102-112: yaw wraps mod 2pi, pitch clamps."""
        yaw = math.fmod(self.yaw + MOUSE_SENSITIVITY * delta_x, 2.0 * math.pi)
        if yaw < 0.0:
            yaw += 2.0 * math.pi  # Zig @mod is floored-division modulo.
        pitch = min(max(self.pitch + MOUSE_SENSITIVITY * delta_y, -PITCH_LIMIT), PITCH_LIMIT)
        return dataclasses.replace(self, pitch=pitch, yaw=yaw)

    def view_matrix(self, world_up: np.ndarray | None = None) -> np.ndarray:
        """src/Camera.zig:114-123."""
        if world_up is None:
            world_up = math3d.WORLD_SPACE.up.vector()
        target = self.position + self.forward()
        return math3d.look_at(self.position, target, world_up)
