"""The benchmark's inputs, generated from a seed: scenes and camera tracks.

``scene_inputs(recipe, seed, cache)`` makes what a configuration's scene
recipe names and returns it in the form both sides read: the program
(portbench/system.py) and the reference (portbench/reference/scene.py).
Each recipe ``kind`` is a module of portbench/recipes/, found by its name;
the generators it draws on are frozen here (standin.py, encode.py).
"""

from __future__ import annotations

from portbench import recipes


def scene_inputs(recipe: dict, seed: int, cache) -> dict:
    return recipes.module(recipe["kind"]).inputs(recipe, seed, cache)
