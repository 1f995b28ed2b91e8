"""Render the reference screenshots' recovered camera poses side by side.

Counterpart of tools/parity_render.py: renders each pose of
docs/parity/poses.json (fitted by fit_pose) at its screenshot's
client-area size and writes {name}_tpurast_torch.png (the frame) and
{name}_side_by_side.png (the screenshot, an 8-px white band, the frame)
into --out, by default tpurast_torch/_build/parity/, never docs/parity/
(the JAX package's images). One Renderer per scene and size renders all
of its poses: on a CUDA device one graph replay each.

The screenshots (each pose's "ref", title rows dropped) and the scenes'
meshes (--data-dir) are the reference's; a missing one exits 2 and names
it. The images are read and written with PIL. --device is "cuda" by
default; "cpu" runs the kernels' plain versions.

Run: python -m tpurast_torch.tools.parity_render --data-dir DATA [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import numpy as np

from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import _common
from tpurast_torch.tools.fit_pose import load_scene, screenshot

REPO = pathlib.Path(__file__).resolve().parents[2]
#: The fitted poses, read only.
POSES_JSON = REPO / "docs" / "parity" / "poses.json"
DEFAULT_OUT = REPO / "tpurast_torch" / "_build" / "parity"
BAND_PX = 8


def render_pose(renderer: Renderer, spec: dict) -> np.ndarray:
    """The (H, W, 3) u8 frame of spec's camera (its "position" and
    "target")."""
    cam = Camera.from_target(np.asarray(spec["position"], np.float32), np.asarray(spec["target"], np.float32))
    return np.ascontiguousarray(renderer.render_to_host(cam)[..., :3])


def side_by_side(ref_img: np.ndarray, ours: np.ndarray) -> np.ndarray:
    """The screenshot, a white band of BAND_PX columns, then our frame."""
    h = ref_img.shape[0]
    return np.concatenate([ref_img, np.full((h, BAND_PX, 3), 255, np.uint8), ours], axis=1)


def render_poses(scene, poses, *, width: int, height: int, device="cuda") -> list[np.ndarray]:
    """render_pose of each pose spec in poses through one Renderer of
    scene at width x height on device."""
    r = Renderer(scene, RendererConfig(width=width, height=height), device=device)
    return [render_pose(r, spec) for spec in poses]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--data-dir", default=None, help="the reference's data directory (meshes/, textures/)")
    ap.add_argument("--device", default="cuda", help='"cuda" (default), "cuda:N" or "cpu"')
    args = ap.parse_args(argv)

    device = _common.open_device("parity_render", args.device)
    if device is None:
        return 2
    with open(POSES_JSON) as fh:
        poses = json.load(fh)
    refs = {}
    for name, spec in poses.items():
        if not os.path.isfile(spec["ref"]):
            print(f"parity_render: {name}: the screenshot {spec['ref']} does not exist", file=sys.stderr)
            return 2
        refs[name] = screenshot(spec["ref"])
    # Poses of one scene and size share a Renderer.
    groups: dict[tuple, list[str]] = {}
    for name, spec in poses.items():
        h, w = refs[name].shape[:2]
        groups.setdefault((spec["scene"], w, h), []).append(name)
    scenes, ours = {}, {}
    for (kind, w, h), names in groups.items():
        if kind not in scenes:
            try:
                scenes[kind] = load_scene(kind, args.data_dir)
            except FileNotFoundError as e:
                print(f"parity_render: {e} (pass --data-dir)", file=sys.stderr)
                return 2
        frames = render_poses(scenes[kind], [poses[n] for n in names], width=w, height=h, device=device)
        ours.update(zip(names, frames))

    from PIL import Image

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, spec in poses.items():
        h, w = refs[name].shape[:2]
        Image.fromarray(ours[name]).save(out_dir / f"{name}_tpurast_torch.png")
        Image.fromarray(side_by_side(refs[name], ours[name])).save(out_dir / f"{name}_side_by_side.png")
        print(f"{name}: {w}x{h} IoU(fit)={spec['iou']:.3f} -> {name}_side_by_side.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
