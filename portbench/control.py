"""The control of the comparison that decides ``correct``: the reference put
in the program's place one precision lower, which has to come out as not
correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--frames 4] [--device cuda]

For each seed the cell's scene is made as a run makes it, ``--frames``
poses are drawn from the seed, and the reference renders them twice: with
the texels as the configuration stores them, and one precision lower
(bfloat16 page -> float8 e4m3; srgb8 rows -> their top 4 bits; float16
rows -> float8; see reference/render.py texel_store). The numbers that
decide ``correct`` (check.py) are printed for each seed as one JSON line,
beside the cell's limits. The benchmark's own runs never run this; it is
how the limits' upper readings were taken (PERF.md), at the cell's own
size on the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    import torch

    from portbench import check, run, scenes
    from portbench.reference import render as rrender
    from portbench.scenes import tracks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, config, traffic = run.cell_files(run.load_json(run.ROOT / "BENCHMARK.json"), args.workload)
    fields = {**config.get("renderer", {}), **traffic.get("renderer", {})}
    target = rrender.target_of(config, fields)
    poses = tracks.circle_track(traffic["track"], traffic["poses"])
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs = scenes.scene_inputs(config["scene"], seed, run.CACHE)
        picks = np.random.default_rng(seed).choice(len(poses), args.frames, replace=False)
        chosen = [poses[int(k)] for k in picks]
        want, _ = check.reference_frames(inputs, fields, target, chosen, args.device)
        lower, _ = check.reference_frames(inputs, fields, target, chosen, args.device, lower=True)
        numbers = check.compare(lower, want)
        print(json.dumps({"workload": args.workload, "seed": seed, "poses": [int(k) for k in picks],
                          "control": numbers, "limits": traffic["limits"],
                          "correct": check.judge(numbers, traffic["limits"])}), flush=True)
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
