"""tpurast_torch: the PyTorch + CUDA port of tpurast for NVIDIA Hopper.

The JAX package ``tpurast`` is the reference. This package renders the
same frames from the same scenes and the same ``RendererConfig``, with the
reference's Pallas kernels replaced by hand-written CUDA kernels
(``tpurast_torch/csrc``) and the XLA glue between them by torch ops. Both
shading paths and both samplers render: forward shading through the
texel-window sampler (the default) or the row-atlas gather, and deferred
shading, over atlas rows in float32, float16, bfloat16 or srgb8.
``tpurast_torch.tools`` holds the device microbenchmarks, with CUDA
kernels for the reference tools' Pallas probes. The runtime is here too:
``Engine`` (frame loop, fly camera, frame statistics), ``Presenter``
(double-buffered read-back through pinned memory), ``render_frame``'s
``stage=`` prefixes with ``profiling.stage_sweep``, the bench's named
scenes and ``python -m tpurast_torch.cli``, the benchmark entry point, with
scan binning and slab frames (``parallel``). On a CUDA device a frame is a
CUDA graph replay (``graphs.FrameGraph``, the reference's ``jax.jit``).
``tracing`` is the program's own trace: host spans, seven stage marks a
frame inside the frame's graph and per-frame counters, read with
``tracing.snapshot()``.

It imports torch and never jax, and nothing of ``tpurast``: the host-side
numpy modules it needs are its own copies under the same names (config,
math3d, camera, assets with the native BC decoder, the host parts of
device.textures, device.pages and device.scene, and present.interleave in
kernels/present.py).
"""

from tpurast_torch.config import RendererConfig  # noqa: F401


def __getattr__(name: str):
    # Engine and Presenter import torch: resolved on first use, so that
    # importing the package stays as cheap as importing its config.
    if name == "Engine":
        from tpurast_torch.engine import Engine

        return Engine
    if name == "Presenter":
        from tpurast_torch.present import Presenter

        return Presenter
    raise AttributeError(f"module 'tpurast_torch' has no attribute {name!r}")
