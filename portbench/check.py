"""How ``correct`` is decided: the sampled frames against the reference's.

The frames the reservoir kept (portbench/loops.py: the colour the timed
path returned, or the image the Presenter handed to the host) are put
beside the reference's frame of the same pose (portbench/reference/),
channel by channel in sRGB 8-bit codes. The numbers compared:

  max_lsb              the largest difference of any channel of any
                       sampled frame, in codes;
  dropped_pair_frames  the frames of the window, every one of them, whose
                       bin_overflow (the (tile, face) pairs the program's
                       binner dropped) is not 0.

max_lsb's limit is the one the traffic mix names (``limits``): the
configuration states a frame within 1 LSB of the reference renderer's
(BASELINE.md). A frame whose shape or type is not the reference's fails
it. dropped_pair_frames' limit is 0 for every mix (GUARANTEES): a frame
that drops pairs leaves faces out. PERF.md gives the readings each limit
was checked against.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import render as rrender
from portbench.reference import scene as rscene

#: Limits that hold in every cell, whatever its traffic mix.
GUARANTEES = {"dropped_pair_frames": 0}


def as_planes(frame) -> torch.Tensor:
    """A sampled frame as (4, H, W) uint8 on the host: the program's
    channel-planar colour, or the Presenter's (H, W, 4) image."""
    if isinstance(frame, np.ndarray):
        frame = torch.from_numpy(frame)
    frame = frame.cpu()
    if frame.dim() == 3 and frame.shape[-1] == 4 and frame.shape[0] != 4:
        frame = frame.permute(2, 0, 1)
    return frame.contiguous()


def compare(got: list, want: list) -> dict:
    """The compared numbers of sampled frames against the reference's."""
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            return {"max_lsb": float("inf")}
        worst = max(worst, int((g.int() - w.int()).abs().max()))
    return {"max_lsb": float(worst)}


def reference_frames(inputs: dict, fields: dict, target, poses: list, device, lower: bool = False,
                     stats_poses=()) -> tuple[list, list]:
    """The reference's colour at ``poses`` and its work counts (yardstick)
    at ``stats_poses``, computed on ``device``; ``fields`` are the
    renderer settings of the configuration and the traffic mix."""
    scene = rscene.from_inputs(inputs)
    dr = rrender.to_device(scene, rrender.texel_format(scene, fields), device, lower)
    del scene
    frames = [rrender.render(dr, target, *p).color.cpu() for p in poses]
    stats = [rrender.render(dr, target, *p, want_stats=True).stats for p in stats_poses]
    return frames, stats


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
