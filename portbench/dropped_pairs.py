"""Dropped pairs along a camera track: how many (tile, face) pairs the
program's binner drops at each pose (its frames' bin_overflow), how many
faces the reference's own triangle setup finds cut by the eye plane there,
and how far the program's frames lie from the reference's at the poses that
drop most and at poses that drop none.

    python3 -m portbench.dropped_pairs --config porsche_class_1080p --traffic viewer_orbit --seeds 1,2
    python3 -m portbench.dropped_pairs --config porsche_class_1080p --traffic viewer_orbit \\
        --circle 1.2,0.75,0.4,0.01,0,0.95,0 --seeds 1
    python3 -m portbench.dropped_pairs --config-file my_config.json --traffic viewer_orbit --seeds 1

``--circle radius,y,angle0,step,tx,ty,tz`` replaces the mix's track (the
second line is the reference bench's slow orbit near the crate and dragon,
tpurast_torch/cli.py flythrough). ``--config-file`` reads a configuration
that is not under portbench/configs/. One JSON line a seed: besides the
totals, ``dropped`` and ``eye_plane_faces`` pose by pose (a cut face the
setup keeps, front-facing and on screen, is binned to every tile). The
benchmark's own runs never run this: it is how PERF.md's readings of the
tracks were taken.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np


def eye_plane_faces(scene, target, poses, device) -> list[int]:
    """Per pose, the faces of ``scene`` (a RefScene) that the reference's
    triangle setup keeps and finds cut by the eye plane."""
    import torch

    from portbench.reference import math3d as m3
    from portbench.reference import render as rrender

    corners = torch.from_numpy(scene.corner_world).to(device)
    counts = []
    for position, look_at in poses:
        vp, _ = m3.frame_uniforms(position, look_at, target.width, target.height, math.radians(target.vfov_deg),
                                  target.znear)
        clip = rrender.transform_corners(corners, torch.from_numpy(vp).to(device))
        setup = rrender.triangle_setup(clip, scene.n_faces, target.width, target.height)
        counts.append(int((setup["valid"] & setup["cut"]).sum()))
    return counts


def main(argv: list[str] | None = None) -> int:
    import torch

    from portbench import check, run, scenes, system
    from portbench.reference import render as rrender
    from portbench.reference import scene as rscene
    from portbench.scenes import tracks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--config", help="a configuration of portbench/configs/, by name")
    which.add_argument("--config-file", help="a configuration's file, by path")
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--circle", help="radius,y,angle0,step,tx,ty,tz")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--compare", type=int, default=4, help="poses compared with the reference, half of them dropping")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = run.load_json(args.config_file or run.BENCH / "configs" / f"{args.config}.json")
    traffic = run.load_json(run.BENCH / "traffic" / f"{args.traffic}.json")
    track = traffic["track"]
    if args.circle:
        r, y, a0, step, tx, ty, tz = (float(v) for v in args.circle.split(","))
        track = {"target": [tx, ty, tz], "radius": r, "y": y, "angle0": a0, "step": step}
    fields = {**config.get("renderer", {}), **traffic.get("renderer", {})}
    target = rrender.target_of(config, fields)
    poses = tracks.circle_track(track, traffic["poses"])
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = scenes.scene_inputs(config["scene"], seed, run.CACHE)
        renderer = system.renderer(system.program_scene(inputs), config["width"], config["height"], fields, dev)
        cams = system.cameras(poses)
        renderer.render(cams[0])
        counts = [renderer.render_with_uniforms(*renderer.frame_uniforms(c))["bin_overflow"].reshape(()) for c in cams]
        dropped = torch.stack(counts).cpu().numpy().astype(np.int64)
        bad = np.flatnonzero(dropped)
        half = args.compare // 2
        worst = [int(k) for k in np.argsort(-dropped, kind="stable")[:half] if dropped[k] > 0]
        clean = [int(k) for k in np.flatnonzero(dropped == 0)]
        clean = [clean[round(i * (len(clean) - 1) / max(args.compare - len(worst) - 1, 1))]
                 for i in range(args.compare - len(worst))] if clean else []
        picks = worst + clean
        got = [renderer.render_with_uniforms(*renderer.frame_uniforms(cams[k]))["color"].cpu() for k in picks]
        del renderer, cams
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cut = eye_plane_faces(rscene.from_inputs(inputs), target, poses, dev)
        began = time.perf_counter()
        want, _ = check.reference_frames(inputs, fields, target, [poses[k] for k in picks], dev)
        reference_s = time.perf_counter() - began
        lsb = {k: check.compare([g], [w])["max_lsb"] for k, g, w in zip(picks, got, want)}
        print(json.dumps({"seed": seed, "track": track, "poses": len(poses), "poses_dropping": int(len(bad)),
                          "first_last_dropping": [int(bad[0]), int(bad[-1])] if len(bad) else None,
                          "pairs_dropped_max": int(dropped.max()), "pairs_dropped_total": int(dropped.sum()),
                          "pairs_dropped_median_of_dropping": float(np.median(dropped[bad])) if len(bad) else 0.0,
                          "eye_plane_faces_max": max(cut), "poses_with_eye_plane_faces": sum(c > 0 for c in cut),
                          "reference_s": reference_s, "reference_frames": len(picks),
                          "max_lsb_by_pose": {str(k): {"dropped": int(dropped[k]), "eye_plane_faces": cut[k],
                                                       "max_lsb": v} for k, v in lsb.items()},
                          "dropped": dropped.tolist(), "eye_plane_faces": cut}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
