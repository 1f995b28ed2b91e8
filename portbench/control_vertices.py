"""A second control of the comparison that decides ``correct``: the plain
reference with the scene's vertex data one precision lower, which has to come
out as not correct.

    python3 -m portbench.control_vertices --workload <cell> --seeds 1,2,3 [--frames 4] [--device cuda]

portbench/control.py lowers the texels (reference/render.py texel_store). A
scene whose faces bind only the fallback texture, a 64 x 64 checker of
colours that float8 holds nearly exactly (dragons64_4k), reads within 1 LSB
of the reference that way, so texel precision is not what its comparison can
tell apart. Here the geometry is lowered instead: the world corners,
normals and UVs the configuration states in float32 are rounded to float16,
the next IEEE precision below, and the reference renders the same poses from
them. Poses are drawn from the seed as control.py draws them. One JSON line a
seed, the numbers beside the cell's limits. The benchmark's own runs never
run this; it is how PERF.md's reading of that control was taken.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

CORNERS = ("corner_world", "corner_normal", "corner_uv")


def lowered(scene):
    """The RefScene with its corner tables rounded to float16 (in place)."""
    for name in CORNERS:
        setattr(scene, name, getattr(scene, name).astype(np.float16).astype(np.float32))
    return scene


def frames(inputs: dict, fields: dict, target, poses: list, device) -> list:
    """The reference's colour at ``poses`` from the lowered scene."""
    from portbench.reference import render as rrender
    from portbench.reference import scene as rscene

    scene = lowered(rscene.from_inputs(inputs))
    dr = rrender.to_device(scene, rrender.texel_format(scene, fields), device)
    return [rrender.render(dr, target, *p).color.cpu() for p in poses]


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
        numbers = check.compare(frames(inputs, fields, target, chosen, args.device), want)
        print(json.dumps({"workload": args.workload, "seed": seed, "poses": [int(k) for k in picks],
                          "control_vertices": numbers, "limits": traffic["limits"],
                          "correct": check.judge(numbers, traffic["limits"])}), flush=True)
        if args.device.startswith("cuda"):
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
