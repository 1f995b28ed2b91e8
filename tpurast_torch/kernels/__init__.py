"""The port's compute stages: torch ops plus hand-written Hopper kernels.

Stages of one frame (tpurast_torch.renderer.render_frame):

  geometry.py — corner transform, triangle setup, pair binning (torch ops)
  raster.py   — visibility: depth + winning face id per pixel (CUDA kernel)
  resolve.py  — per-pixel G-buffer of the winning face (CUDA kernel)
  sampler.py  — texel window plan per tile (CUDA kernel), anisotropic
                trilinear texturing from the page + lighting (CUDA kernel)
  shade.py    — the lighting / footprint formulas shared by the plain
                paths, and the row-atlas gather and deferred shading
                (torch ops)
  present.py  — sRGB encode and crops (torch ops)

and, for the device microbenchmarks (tpurast_torch/tools):

  probes.py   — row sums of an on-chip table (CUDA kernel vmem_take) and
                a scaled G-buffer plane copy (CUDA kernel plane_scale)

Dispatch rule, the counterpart of tpurast.kernels.interpret_mode: every
kernel wrapper looks at the tensors it was given. CPU tensors take the
kernel's plain torch version (in the same module), which is what the CPU
tests run; CUDA tensors launch the CUDA kernel, and a failed build or
launch raises. There is no fallback from one to the other.

``plain_kernels()`` is the counterpart of tpurast.kernels.force_interpret: a
context in which the wrappers take their plain versions for CUDA tensors
too, so that one frame can be rendered both ways on the same device. Only
a comparison enters it (the bench's parity gate, chip_smoke.py, the
tests), never a frame loop.

Each wrapper adds one to its entry of ``LAUNCHES`` when it launches its
CUDA kernel, and nowhere else, so a run can show that the main path went
through the kernels.
"""

from __future__ import annotations

import contextlib

import torch

#: CUDA launches per kernel since the last reset_launches().
LAUNCHES = {"raster": 0, "resolve": 0, "plan": 0, "sample": 0, "vmem_take": 0, "plane_scale": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_plain_depth = 0  # nesting depth of plain_kernels()


@contextlib.contextmanager
def plain_kernels():
    """Within the context every kernel wrapper runs its plain torch version,
    on CUDA tensors too (and counts no launch)."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors live on one CUDA device (launch the kernel),
    False when they all live on the CPU (run the plain version) or, inside
    plain_kernels(), on one CUDA device. Anything else is an error."""
    devices = {t.device for t in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return _plain_depth == 0
    raise ValueError(f"kernel inputs must all be on the CPU or all on one CUDA device, got {devices}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Validate a kernel argument before its pointer is passed to C."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
