"""Fit a camera pose to a reference screenshot by coverage-mask search.

Counterpart of tools/fit_pose.py: renders the scene over a random
coarse-to-fine search of (position, target) and scores the coverage mask
(depth > clear) against the screenshot's non-background mask (IoU), or,
with --mask-mode brown, the wood-hue mask of both images. The camera is a
frame uniform, so on a CUDA device every candidate pose is one replay of
the Renderer's CUDA graph and one read-back of its mask. The random
stream is the reference's draw for draw (numpy's default_rng(0)), so the
same masks give the same improvement lines.

Options are the reference's, with its meanings, plus --device ("cuda" by
default; "cpu" runs the kernels' plain versions) and the procedural
scene, --scene orbit. --seed keeps the reference's meaning, a warm-start
pose JSON from an earlier run, so the orbit scene's seed (--seed in the
port's other tools) is --scene-seed here. --scene dragon and demo read the
reference's data directory (--data-dir); a missing directory, --ref or
--seed file exits 2 and names it. --out defaults to pose.json in the
temporary directory ($TMPDIR). ref_mask, --mask-mode brown and --save-best
read or write images with PIL.

Run: python -m tpurast_torch.tools.fit_pose --ref shot.png --scene orbit --rmin 10.5 --rmax 13 --iters 200
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from tpurast_torch import math3d
from tpurast_torch.assets.gltf import load_glb
from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.device import scene as scene_mod
from tpurast_torch.device.scene_cache import load_named_scene
from tpurast_torch.renderer import Renderer
from tpurast_torch.tools import _common

#: Rows of the window title bar above each screenshot's client area.
TITLE_PX = 31
#: The search centre of each scene unless --center gives one: the dragon's
#: and the demo scene's as in the reference; on the orbit scene
#: orbit_camera's target.
CENTERS = {"dragon": (0.0, 0.95, 0.0), "demo": (0.0, 1.0, 0.0), "orbit": (0.0, 1.0, 0.0)}


def screenshot(path: str, title_px: int = TITLE_PX) -> np.ndarray:
    """The screenshot at path as (H, W, 3) u8 RGB without its title rows."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))[title_px:]


def resized(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """img resized to w x h, bilinearly, by PIL (as the reference does)."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


def ref_mask(path_or_image, w: int, h: int, title_px: int = TITLE_PX):
    """(mask (h, w) bool, the screenshot without its title rows): pixels
    whose summed difference from the background, the median of three
    corner patches, exceeds 110 after a bilinear resize to w x h. An image
    is the screenshot's (H, W, 3) u8 pixels, title rows included."""
    if isinstance(path_or_image, np.ndarray):
        img = path_or_image[title_px:]
    else:
        img = screenshot(path_or_image, title_px)
    # An overlay box (frame time) sits top-left in some shots; the
    # background key comes from the other corners.
    corners = np.concatenate(
        [
            img[2:12, -12:-2].reshape(-1, 3),
            img[-12:-2, 2:12].reshape(-1, 3),
            img[-12:-2, -12:-2].reshape(-1, 3),
        ]
    )
    bg = np.median(corners, axis=0)
    small = resized(img, w, h).astype(np.float32)
    return (np.abs(small - bg).sum(-1) > 110.0), img


def brown(img: np.ndarray) -> np.ndarray:
    """Wood-hue classifier (the crate texture): warm, desaturated red,
    clearly not the magenta floor and sky (b ~ r there) or a green dragon."""
    rr = img[..., 0].astype(np.int32)
    gg = img[..., 1].astype(np.int32)
    bb = img[..., 2].astype(np.int32)
    return (rr > 50) & (rr * 10 > gg * 11) & (gg * 10 > bb * 11) & (rr < 240)


def iou(a: np.ndarray, b: np.ndarray):
    inter = (a & b).sum()
    union = (a | b).sum()
    return inter / max(union, 1)


def search(render_mask, mask_ref, center, *, iters: int, rmin: float, rmax: float, sigma: float, warm=None,
           log=print):
    """The reference's coarse-to-fine random search: positions on a sphere
    of radius rmin..rmax around center, then steps around the running best
    that shrink with the iteration. render_mask(camera) is a pose's mask;
    warm, a pose dict ("position", "target"), starts from that pose and
    never jumps again. Each improvement is logged as the reference prints
    it. Returns (score, position, target)."""
    center = np.asarray(center, np.float64)
    rng = np.random.default_rng(0)
    best = (-1.0, None)
    if warm is not None:
        spos = np.array(warm["position"])
        stgt = np.array(warm["target"])
        cam = Camera.from_target(spos.astype(np.float32), stgt.astype(np.float32))
        best = (iou(render_mask(cam), mask_ref), (spos, stgt))
        log(f"seed IoU {best[0]:.4f}")
    for it in range(iters):
        tscale = max(0.05, 1.0 - it / iters)
        # No draw while best is empty, and none for the jump after a warm start.
        if best[1] is None or (warm is None and rng.uniform() < 0.2):
            rad = rng.uniform(rmin, rmax)
            az = rng.uniform(0, 2 * np.pi)
            el = rng.uniform(-0.9, 0.9)
            pos = center + rad * np.array([np.cos(el) * np.sin(az), -np.sin(el), -np.cos(el) * np.cos(az)])
            tgt = center + rng.normal(0, 0.03, 3)
        else:
            bpos, btgt = best[1]
            pos = bpos + rng.normal(0, sigma * tscale, 3)
            tgt = btgt + rng.normal(0, sigma * 0.4 * tscale, 3)
        cam = Camera.from_target(pos.astype(np.float32), tgt.astype(np.float32))
        score = iou(render_mask(cam), mask_ref)
        if score > best[0]:
            best = (score, (pos.copy(), tgt.copy()))
            log(f"iter {it}: IoU {score:.4f} pos {pos.round(4).tolist()} tgt {tgt.round(4).tolist()}")
    score, (pos, tgt) = best
    return score, pos, tgt


def fit(scene, mask_ref, *, width: int = 320, height: int = 180, device="cuda", mask_mode: str = "coverage",
        center, iters: int = 600, rmin: float = 0.08, rmax: float = 0.6, sigma: float = 0.08, warm=None,
        log=print):
    """search() over one Renderer of scene at width x height on device:
    mask_mode "coverage" scores depth > 0, "brown" the wood-hue mask of the
    frame. Returns (score, position, target, the Renderer)."""
    r = Renderer(scene, RendererConfig(width=width, height=height), device=device)
    if mask_mode == "coverage":
        def render_mask(cam):
            return (r.render(cam)["depth"] > 0).cpu().numpy()
    elif mask_mode == "brown":
        def render_mask(cam):
            return brown(r.render_to_host(cam))
    else:
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    score, pos, tgt = search(render_mask, mask_ref, center, iters=iters, rmin=rmin, rmax=rmax, sigma=sigma,
                             warm=warm, log=log)
    return score, pos, tgt, r


def load_scene(kind: str, data_dir: str | None = None, seed: int = 0):
    """The pose tools' scenes: "dragon" (the Stanford dragon alone, one
    unit down, as the reference's tools place it) and "demo" read data_dir
    (FileNotFoundError names what is missing); "orbit" is the procedural
    scene of seed."""
    if kind == "orbit":
        return load_named_scene("orbit", seed=seed)
    if data_dir is None or not os.path.isdir(data_dir):
        raise FileNotFoundError(f"scene {kind!r} reads the data directory {data_dir!r}, which does not exist")
    if kind == "demo":
        return scene_mod.load_demo_scene(data_dir)
    if kind != "dragon":
        raise ValueError(f"unknown scene {kind!r}")
    path = os.path.join(data_dir, "meshes", "stanford_dragon.glb")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path} does not exist")
    up = math3d.WORLD_SPACE.up.vector()
    return scene_mod.build_scene([load_glb(path, post_transform=math3d.translation(up * -1.0))],
                                 data_dir=data_dir)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", required=True)
    ap.add_argument("--scene", default="dragon", choices=list(CENTERS))
    ap.add_argument("--data-dir", default=None, help="the reference's data directory (meshes/, textures/)")
    ap.add_argument("--scene-seed", type=int, default=0, help="seed of the procedural scene (--scene orbit)")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--center", type=float, nargs=3, default=None, help="search center (world)")
    ap.add_argument("--rmin", type=float, default=0.08)
    ap.add_argument("--rmax", type=float, default=0.6)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "pose.json"))
    ap.add_argument("--save-best", default=None)
    ap.add_argument("--seed", default=None, help="warm-start pose JSON from a previous run")
    ap.add_argument("--sigma", type=float, default=0.08, help="refinement step scale")
    ap.add_argument(
        "--mask-mode",
        default="coverage",
        choices=["coverage", "brown"],
        help="coverage: non-background silhouette (useless for enclosed "
        "scenes: the arena box covers every pixel); brown: wood-hue mask "
        "(the crate) applied to BOTH images, robust for demo-scene poses",
    )
    ap.add_argument("--device", default="cuda", help='"cuda" (default), "cuda:N" or "cpu"')
    args = ap.parse_args(argv)

    device = _common.open_device("fit_pose", args.device)
    if device is None:
        return 2
    for opt, path in (("--ref", args.ref), ("--seed", args.seed)):
        if path and not os.path.isfile(path):
            print(f"fit_pose: {opt} {path} does not exist", file=sys.stderr)
            return 2
    try:
        scene = load_scene(args.scene, args.data_dir, args.scene_seed)
    except FileNotFoundError as e:
        print(f"fit_pose: {e} (pass --data-dir, or --scene orbit for the procedural scene)", file=sys.stderr)
        return 2
    center = np.array(CENTERS[args.scene] if args.center is None else args.center)
    if args.mask_mode == "brown":
        mask_ref = brown(resized(screenshot(args.ref), args.width, args.height))
    else:
        mask_ref, _ = ref_mask(args.ref, args.width, args.height)
    warm = None
    if args.seed:
        with open(args.seed) as fh:
            warm = json.load(fh)

    score, pos, tgt, r = fit(
        scene, mask_ref, width=args.width, height=args.height, device=device, mask_mode=args.mask_mode,
        center=center, iters=args.iters, rmin=args.rmin, rmax=args.rmax, sigma=args.sigma, warm=warm,
        log=lambda line: print(line, flush=True),
    )
    with open(args.out, "w") as fh:
        json.dump({"iou": float(score), "position": pos.tolist(), "target": tgt.tolist(), "scene": args.scene,
                   "ref": args.ref}, fh, indent=1)
    print("best IoU", score, "->", args.out)
    if args.save_best:
        from PIL import Image

        cam = Camera.from_target(pos.astype(np.float32), tgt.astype(np.float32))
        Image.fromarray(r.render_to_host(cam)[..., :3]).save(args.save_best)
    return 0


if __name__ == "__main__":
    sys.exit(main())
