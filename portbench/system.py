"""The system under test, tpurast_torch, through its public entry points.

The benchmark builds the program's scene from the generated inputs (the
public loader of device/scene.py that the scene's recipe names), its
Renderer from the configuration's RendererConfig fields, its cameras from
the track's poses (camera.Camera.from_target) and, for the present loop,
its Presenter. Nothing else of the program is read: the yardstick, the
reference and the comparison live in this package.
"""

from __future__ import annotations

from portbench import recipes


def program_scene(inputs: dict):
    """The program's host scene (a DeviceScene) from scene_inputs' result:
    the call its recipe names, of a public ``load_*`` function of
    tpurast_torch.device.scene."""
    name, args, kwargs = recipes.module(inputs["kind"]).program_loader(inputs)
    from tpurast_torch.device import scene as scene_mod

    if not name.startswith("load_") or not callable(getattr(scene_mod, name, None)):
        raise ValueError(f"scene recipe {inputs['kind']!r} names no loader of tpurast_torch.device.scene: {name!r}")
    return getattr(scene_mod, name)(*args, **kwargs)


def renderer(scene, width: int, height: int, fields: dict, device):
    """A Renderer of ``scene`` at width x height with RendererConfig
    ``fields`` (lists as tuples)."""
    from tpurast_torch.config import RendererConfig
    from tpurast_torch.renderer import Renderer

    cfg = RendererConfig(width=width, height=height,
                         **{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})
    return Renderer(scene, cfg, device=device)


def cameras(poses):
    from tpurast_torch.camera import Camera

    return [Camera.from_target(pos, target) for pos, target in poses]


def presenter():
    from tpurast_torch.present import Presenter

    return Presenter()
