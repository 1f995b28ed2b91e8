"""tpurast_torch: the PyTorch + CUDA port of tpurast for NVIDIA Hopper.

The JAX package ``tpurast`` is the reference. This package renders the
same frames from the same scenes and the same ``RendererConfig``, with the
reference's Pallas kernels replaced by hand-written CUDA kernels
(``tpurast_torch/csrc``) and the XLA glue between them by torch ops. Both
shading paths and both samplers render: forward shading through the
texel-window sampler (the default) or the row-atlas gather, and deferred
shading, over atlas rows in float32, float16, bfloat16 or srgb8.
``tpurast_torch.tools`` holds the device microbenchmarks, with CUDA
kernels for the reference tools' Pallas probes. Scan binning, slabs,
``stage=`` prefixes and the runtime (Engine, Presenter) are not ported
yet and raise NotImplementedError.

It imports torch and never jax, and nothing of ``tpurast``: the host-side
numpy modules it needs are its own copies under the same names (config,
math3d, camera, assets with the native BC decoder, the host parts of
device.textures, device.pages and device.scene, and present.interleave in
kernels/present.py).
"""

_NOT_PORTED = {
    "Engine": "item 13 (runtime)",
    "Presenter": "item 13 (runtime)",
}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"tpurast_torch.{name} is not ported yet (ROADMAP queue 1 {_NOT_PORTED[name]})"
        )
    raise AttributeError(f"module 'tpurast_torch' has no attribute {name!r}")
