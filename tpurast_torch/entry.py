"""The port's counterpart of ``__graft_entry__.entry``: the single-card check.

    fn, args = entry(data_dir)       # on the card
    out = fn(*args)                  # color, depth, bin_overflow, window_miss_px

It does what the reference's entry does (``__graft_entry__.py:7-30``): the
dragon mesh from ``data_dir`` built into a scene, a 256x128 RendererConfig,
the camera from (0, 0.05, -0.4) toward (0, 0.05, 0) and its frame uniforms.
It returns the Renderer's frame function, ``Renderer._frame_fn("frame")``
(a graphs.FrameGraph on the card, whose first call renders eagerly and
captures the graph; render_frame itself on the CPU), and its arguments
(scene, view_proj, cam_pos). ``data_dir`` is the reference's data directory
or a stand-in written by tpurast_torch.tools.standin_data (the reference
hard-codes its directory, ``__graft_entry__.py:12-13``). It runs on the card
unless ``device`` asks for the CPU.
"""

from __future__ import annotations

import os

from tpurast_torch.assets.gltf import load_glb
from tpurast_torch.camera import Camera
from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import build_scene
from tpurast_torch.renderer import Renderer

WIDTH, HEIGHT = 256, 128
EYE, TARGET = (0.0, 0.05, -0.4), (0.0, 0.05, 0.0)


def entry(data_dir, device="cuda"):
    """(fn, (scene, view_proj, cam_pos)): the dragon scene's frame function
    at 256x128 and its example arguments, on ``device``."""
    model = load_glb(os.path.join(data_dir, "meshes", "stanford_dragon.glb"))
    scene = build_scene([model], data_dir=data_dir)
    renderer = Renderer(scene, RendererConfig(width=WIDTH, height=HEIGHT), device=device)
    view_proj, cam_pos = renderer.frame_uniforms(Camera.from_target(list(EYE), list(TARGET)))
    return renderer._frame_fn("frame"), (renderer.scene, view_proj, cam_pos)
