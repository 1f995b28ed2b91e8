"""Camera tracks: the poses a flythrough visits, as (position, target) pairs.

A circle track is a slow orbit: the camera at (radius sin a, y,
-radius cos a) looking at a fixed target, a = angle0 + step * k for
k < poses. The traffic mix gives the circle and the number of poses. A
run starts at a pose drawn from its seed and wraps, so every seed visits
the same poses in another order.
"""

from __future__ import annotations

import math

import numpy as np


def circle_track(track: dict, poses: int) -> list[tuple[np.ndarray, np.ndarray]]:
    target = np.asarray(track["target"], dtype=np.float32)
    out = []
    for k in range(poses):
        a = track["angle0"] + track["step"] * k
        pos = np.array([track["radius"] * math.sin(a), track["y"], -track["radius"] * math.cos(a)], np.float32)
        out.append((pos, target))
    return out


def start_pose(seed: int, poses: int) -> int:
    """The pose a run with ``seed`` starts at."""
    return int(np.random.default_rng(seed).integers(poses))
