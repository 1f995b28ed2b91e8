"""What the analysis tools share: the scene and device options, the scene
itself, the device check, the cameras and the wait for the device.

Each tool's command line takes --scene (default "orbit": the procedural
scene, built from --seed; the named scenes read the reference's data
directory, --data-dir) and --device (default "cuda"; "cpu" runs the
kernels' plain versions and its times are the host's).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpurast_torch.camera import Camera
from tpurast_torch.device.scene import orbit_camera
from tpurast_torch.device.scene_cache import SCENES, load_named_scene


def add_scene_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--scene", default="orbit", choices=list(SCENES))
    ap.add_argument("--data-dir", default=None, help="the reference's data directory (meshes/, textures/)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the procedural scene (orbit)")
    ap.add_argument("--device", default="cuda", help='"cuda" (default), "cuda:N" or "cpu"')


def open_device(tool: str, name: str):
    """torch.device(name), or None after saying on stderr that a CUDA
    device was asked for and there is none."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: no CUDA device (torch.cuda.is_available() is false). Pass --device cpu to run the "
              "plain torch versions on the host.", file=sys.stderr)
        return None
    return device


def open_scene(tool: str, args):
    """(scene, device) for a tool's parsed options, or None after saying
    on stderr why not (no CUDA device for --device cuda, a missing data
    directory)."""
    device = open_device(tool, args.device)
    if device is None:
        return None
    try:
        if args.scene == "orbit":
            return load_named_scene("orbit", seed=args.seed), device
        return load_named_scene(args.scene, args.data_dir), device
    except FileNotFoundError as e:
        print(f"{tool}: {e} (pass --data-dir, or --scene orbit for the procedural scene)", file=sys.stderr)
        return None


def camera_at(scene_name: str, angle: float) -> Camera:
    """The single camera of the reference's tools at ``angle`` radians: on
    a 1.2-unit circle 0.75 above the demo scene's floor, aimed at its
    crate; on the orbit scene, orbit_track's camera at that angle."""
    if scene_name == "orbit":
        return orbit_camera(angle)
    pos = np.array([1.2 * np.sin(angle), 0.75, -1.2 * np.cos(angle)], np.float32)
    return Camera.from_target(pos, [0.0, 0.95, 0.0])


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

