"""BASELINE config 2's scene on the stand-in data: the porsche-class scene.

Recipe: ``{"kind": "standin_porsche_class", "scale": "full" | "small",
"textures": n}``.

Data: the stand-in data directory of portbench/scenes/standin.py (the
arena, the dragon-sized blob, the crate and twelve BC7-sRGB textures),
written from the seed into ``<cache>/standin`` and reused while the seed and
scale stay the same. Program: ``load_porsche_class_scene(data_dir,
max_textures=n)``, the first ``n`` porsche textures bound. Reference:
portbench/reference/scene.py ``porsche_class``.
"""

from __future__ import annotations

import os

from portbench.reference import scene as rscene
from portbench.scenes import standin


def inputs(recipe: dict, seed: int, cache) -> dict:
    data_dir = os.path.join(os.fspath(cache), "standin")
    standin.write_standin(data_dir, seed, recipe.get("scale", "full"))
    return {"kind": recipe["kind"], "data_dir": data_dir, "textures": recipe["textures"]}


def program_loader(inputs: dict) -> tuple[str, list, dict]:
    return "load_porsche_class_scene", [inputs["data_dir"]], {"max_textures": inputs["textures"]}


def reference_scene(inputs: dict) -> rscene.RefScene:
    return rscene.porsche_class(inputs["data_dir"], inputs["textures"])
