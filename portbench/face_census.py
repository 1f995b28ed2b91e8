"""The binner's face counts along a camera track: at each pose, what the
program's frame record says of the frame (tpurast_torch/tracing.py): the
faces cut by the eye plane that name a tile (their near-plane boxes), the
huge faces (more than TILES_PER_FACE tiles, of which the binner keeps the
first 64) and the pairs dropped (bin_overflow).

    python3 -m portbench.face_census --config dragons64_4k --traffic flythrough --seeds 1,2
    python3 -m portbench.face_census --config porsche_class_1080p --traffic flythrough --seeds 1,2

One JSON line a seed: the totals, then ``cut``, ``huge`` and ``dropped``
pose by pose (pose k of the track, from its first). The benchmark's own runs
never run this: it is how PERF.md's census of the tracks was taken, beside
portbench/dropped_pairs.py (which compares frames with the reference).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    import torch

    from portbench import run, scenes, system
    from portbench.scenes import tracks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--config", help="a configuration of portbench/configs/, by name")
    which.add_argument("--config-file", help="a configuration's file, by path")
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = run.load_json(args.config_file or run.BENCH / "configs" / f"{args.config}.json")
    traffic = run.load_json(run.BENCH / "traffic" / f"{args.traffic}.json")
    fields = {**config.get("renderer", {}), **traffic.get("renderer", {})}
    poses = tracks.circle_track(traffic["track"], traffic["poses"])
    dev = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = scenes.scene_inputs(config["scene"], seed, run.CACHE)
        renderer = system.renderer(system.program_scene(inputs), config["width"], config["height"], fields, dev)
        cams = system.cameras(poses)
        renderer.render(cams[0])
        first = renderer.marks.enqueued + 1
        for c in cams:
            renderer.render_with_uniforms(*renderer.frame_uniforms(c))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        recs = renderer.marks.frames()
        keep = (recs["seq"] >= first) & (recs["seq"] < first + len(cams))
        if int(keep.sum()) != len(cams) or "cut" not in recs:
            raise SystemExit(f"face_census: {int(keep.sum())} whole records of {len(cams)} frames, or none with "
                             "face counts")
        cut, huge, dropped = (recs[k][keep].astype(np.int64) for k in ("cut", "huge", "overflow"))
        print(json.dumps({"seed": seed, "track": traffic["track"], "poses": len(cams),
                          "width": config["width"], "height": config["height"],
                          "poses_dropping": int((dropped > 0).sum()), "dropped_max": int(dropped.max()),
                          "cut_min_median_max": [int(cut.min()), float(np.median(cut)), int(cut.max())],
                          "huge_min_median_max": [int(huge.min()), float(np.median(huge)), int(huge.max())],
                          "huge_max_pose": int(huge.argmax()), "poses_over_64_huge": int((huge > 64).sum()),
                          "cut": cut.tolist(), "huge": huge.tolist(), "dropped": dropped.tolist()}), flush=True)
        del renderer, cams
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
