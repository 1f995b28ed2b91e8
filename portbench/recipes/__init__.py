"""Scene recipes, one module a ``kind``, found by name.

A configuration's ``scene`` is a recipe: a dict whose ``kind`` names the
module ``portbench/recipes/<kind>.py``, with that module's own parameters
beside it. Each recipe module provides

  inputs(recipe, seed, cache) -> dict
      writes (or reuses) the scene's generated data under ``cache`` and
      returns what both sides read, ``kind`` included;
  program_loader(inputs) -> (name, args, kwargs)
      the public loader of tpurast_torch.device.scene that builds the
      program's scene, and its arguments, as data (portbench/system.py
      makes the call: a recipe never imports the program);
  reference_scene(inputs) -> RefScene
      the reference's scene, assembled from the same files by
      portbench/reference/ alone.

``module(kind)`` accepts only a bare lowercase name (letters, digits and
``_``, not starting with ``_``) of a file that exists here; anything else
raises ValueError("unknown scene recipe ...").
"""

from __future__ import annotations

import importlib
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
KIND = re.compile(r"[a-z0-9][a-z0-9_]*")


def module(kind):
    """The recipe module of ``kind``."""
    if not isinstance(kind, str) or not KIND.fullmatch(kind) or not (HERE / f"{kind}.py").is_file():
        raise ValueError(f"unknown scene recipe {kind!r}")
    return importlib.import_module(f"{__name__}.{kind}")

