"""The benchmark's inputs, generated from a seed: scenes and camera tracks.

``scene_inputs(recipe, seed, cache)`` makes what a configuration's scene
recipe names and returns it in the form both sides read: the program
(portbench/system.py) and the reference (portbench/reference/scene.py).

  standin_porsche_class  the stand-in data directory (standin.py), written
                         under ``cache`` and reused while the seed and
                         scale stay the same; the scene takes its first
                         ``textures`` porsche textures.
"""

from __future__ import annotations

import os

from portbench.scenes import standin


def scene_inputs(recipe: dict, seed: int, cache) -> dict:
    kind = recipe["kind"]
    if kind == "standin_porsche_class":
        data_dir = os.path.join(os.fspath(cache), "standin")
        scale = recipe.get("scale", "full")
        standin.write_standin(data_dir, seed, scale)
        return {"kind": kind, "data_dir": data_dir, "textures": recipe["textures"]}
    raise ValueError(f"unknown scene recipe {kind!r}")
