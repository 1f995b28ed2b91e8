"""BASELINE config 4's scene on the stand-in data: the dragon instanced on a grid.

Recipe: ``{"kind": "standin_dragons64", "scale": "full" | "small",
"count": 64, "spacing": 0.35}``: ``count`` dragons on a square grid
``spacing`` apart (8 x 8 at 64), centred on the origin, each one unit below
it (the reference bench's instanced stress scene).

Data: the frozen dragon blob of portbench/scenes/standin.py at the
recipe's scale (full: 19,332 triangles, so 1,237,248 faces at 64),
written from the seed as ``meshes/stanford_dragon.glb`` into
``<cache>/standin_dragons64``, a directory and marker of its own, so that
runs of this scene and of another never rewrite each other's data. The
blob names the dragon's texture, which the reference's data mount lacks
(``.MISSING_LARGE_BLOBS``) and this directory does not hold either: the
program logs the miss and binds the fallback texture 0, as
tpurast_torch/tools/standin_data.py documents, and the reference does the
same.

Program: ``load_instanced_dragons(data_dir, count, spacing)``, called
directly and not through the program's scene cache, so that a run's
set-up counts the scene's build. Reference: portbench/reference/scene.py
``instanced_dragons``.
"""

from __future__ import annotations

import os

from portbench.reference import scene as rscene
from portbench.scenes import standin


def inputs(recipe: dict, seed: int, cache) -> dict:
    data_dir = os.path.join(os.fspath(cache), "standin_dragons64")
    scale = recipe.get("scale", "full")
    want = {"generator": standin.GENERATOR, "seed": int(seed), "scale": scale, "scene": recipe["kind"]}
    standin.write_marked(data_dir, want,
                         lambda root: standin.put(root, "meshes/stanford_dragon.glb", standin.dragon_glb(seed, scale)))
    return {"kind": recipe["kind"], "data_dir": data_dir, "count": recipe["count"], "spacing": recipe["spacing"]}


def program_loader(inputs: dict) -> tuple[str, list, dict]:
    return "load_instanced_dragons", [inputs["data_dir"], inputs["count"], inputs["spacing"]], {}


def reference_scene(inputs: dict) -> rscene.RefScene:
    return rscene.instanced_dragons(inputs["data_dir"], inputs["count"], inputs["spacing"])
