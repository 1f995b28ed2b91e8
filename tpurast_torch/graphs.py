"""CUDA graphs of the frame functions: the port's counterpart of jax.jit.

The reference compiles its frame function once per render target
(tpurast/renderer.py, "one dispatch + the 4x4 view matrix upload" a
frame), each stage= prefix (tpurast/profiling.py) and the slab frame
(tpurast/parallel.py). Here a ``FrameGraph`` captures
fn(scene, view_proj, camera_position) into a torch.cuda.CUDAGraph and
replays it: one graph launch a frame in place of some 330 eager launches.

  * The first call runs fn eagerly on a side stream: that call builds the
    kernel library with nvcc, outside any capture, and its frame is the
    call's result. Then fn is captured, at that call's shapes and on that
    scene, into a memory pool of the graph's own, reading two static input
    buffers, view_proj (4, 4) and camera_position (3,).
  * Every later call copies the uniforms into the static inputs, replays
    the graph on the current stream and returns clones of the static
    outputs, so that no later replay overwrites a frame a caller still
    holds (Engine reads a frame's counters one frame late, Presenter copies
    a frame while the next one renders). The clones are one copy a tensor:
    color and depth, 16.6 MB at 1920x1080, and two scalars.
  * The kernel launches counted while fn was captured (nothing ran) are
    taken back from kernels.LAUNCHES and added again on every replay, so
    LAUNCHES keeps counting the launches the card runs.
  * Inside kernels.plain_kernels() fn runs eagerly with the plain versions
    and the graph is neither captured nor replayed: the reference reads its
    interpret flag when it traces.
  * A scene on the CPU raises: there is nothing to capture. A capture that
    fails raises with the CUDA error; nothing falls back to eager frames on
    the card.
"""

from __future__ import annotations

import time

import torch

from tpurast_torch import kernels


def graph_wanted(device) -> bool:
    """True where frames run as CUDA graphs: on a CUDA device, outside
    kernels.plain_kernels()."""
    return torch.device(device).type == "cuda" and not kernels.plain_kernels_active()


class FrameGraph:
    """fn(scene, view_proj, camera_position) -> dict of tensors, captured on
    the first call and replayed on the later ones (module docstring).
    After the capture, ``capture_ms`` is the host time of the capture
    (after the eager frame has finished), ``pool_bytes`` the device memory
    the graph's pool reserved and ``launches`` the kernel launches of one
    replay."""

    def __init__(self, fn, name: str = "frame"):
        self.fn = fn
        self.name = name
        self.capture_ms: float | None = None
        self.pool_bytes: int | None = None
        self.launches: dict[str, int] = {}
        self._graph: torch.cuda.CUDAGraph | None = None
        self._scene = None
        self._inputs: tuple[torch.Tensor, torch.Tensor] | None = None
        self._outputs: dict | None = None

    def __call__(self, scene, view_proj, camera_position) -> dict:
        device = scene["corner_world"].device
        if device.type != "cuda":
            raise ValueError(f"{self.name}: a CUDA graph needs a CUDA device, the scene is on {device}")
        if kernels.plain_kernels_active():
            return self.fn(scene, view_proj, camera_position)
        if self._graph is None:
            return self._capture(scene, view_proj, camera_position)
        if scene is not self._scene:
            raise ValueError(f"{self.name}: the graph was captured on another scene")
        vp, cp = self._inputs
        vp.copy_(view_proj, non_blocking=True)
        cp.copy_(camera_position, non_blocking=True)
        self._graph.replay()
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n
        return {k: v.clone() for k, v in self._outputs.items()}

    def _capture(self, scene, view_proj, camera_position) -> dict:
        device = scene["corner_world"].device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = self.fn(scene, view_proj, camera_position)
        current.wait_stream(side)
        for v in first.values():
            v.record_stream(current)

        vp = torch.empty((4, 4), dtype=torch.float32, device=device)
        cp = torch.empty((3,), dtype=torch.float32, device=device)
        vp.copy_(view_proj)
        cp.copy_(camera_position)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                outputs = self.fn(scene, vp, cp)
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: CUDA graph capture failed: {e}") from e
        finally:
            counted = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            kernels.LAUNCHES.update(before)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = {k: n for k, n in counted.items() if n}
        self._graph, self._scene, self._inputs, self._outputs = graph, scene, (vp, cp), outputs
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        return first

    def close(self) -> None:
        """Drop the graph, its static tensors and so its pool; the next call
        captures again."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._scene = self._inputs = self._outputs = None
