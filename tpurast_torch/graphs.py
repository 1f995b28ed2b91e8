"""CUDA graphs of the frame functions: the port's counterpart of jax.jit.

The reference compiles its frame function once per render target
(tpurast/renderer.py, "one dispatch + the 4x4 view matrix upload" a
frame), each stage= prefix (tpurast/profiling.py), the slab frame
(tpurast/parallel.py) and the timed functions of its tools
(tools/profile_sampler.py, tools/sample_stage_probe.py). Here a ``Graph``
captures fn(*inputs), a function of n tensors, into a torch.cuda.CUDAGraph
and replays it; a ``FrameGraph`` is the Graph of
fn(scene, view_proj, camera_position) with the scene held: one graph
launch a frame in place of some 330 eager launches.

  * Everything runs under the graph's device (the first input's; the
    scene's for a FrameGraph): its capture stream, its synchronize, its
    memory pool and its replays. A graph may live on another card than the
    caller's current device.
  * The first call copies the inputs into static buffers of the graph's
    own (the inputs' shapes, dtypes and strides, on the graph's device:
    an input on another card arrives by a device to device copy) and runs
    fn eagerly on them on a side stream: that call builds the kernel
    library with nvcc, outside any capture, and its result is the call's.
    Then fn is captured on the same buffers into a memory pool of the
    graph's own. fn may fork streams of its own from the capture stream
    and join them back (parallel.render_slabs): the graph keeps the fork
    and the join, and the branches run side by side on replay.
  * Every later call copies each input into its buffer (a call that hands
    over the buffers themselves, ``inputs``, copies nothing), replays the
    graph on the device's current stream and returns clones of the static
    outputs, so that no later replay overwrites a result a caller still
    holds (Engine reads a frame's counters one frame late, Presenter copies
    a frame while the next one renders). The clones are one copy a tensor:
    for a frame, color and depth, 16.6 MB at 1920x1080, and two scalars.
  * The kernel launches counted while fn was captured (nothing ran) are
    taken back from kernels.LAUNCHES and added again on every replay, so
    LAUNCHES keeps counting the launches the card runs; so are the frames
    the capture's stage marks counted (tracing.FrameMarks.enqueued).
  * Inside kernels.plain_kernels() fn runs eagerly with the plain versions
    and the graph is neither captured nor replayed: the reference reads its
    interpret flag when it traces.
  * Inputs on the CPU raise: there is nothing to capture. A capture that
    fails raises with the CUDA error; nothing falls back to eager calls on
    the card.
"""

from __future__ import annotations

import functools

import torch

from tpurast_torch import kernels, tracing


def graph_wanted(device) -> bool:
    """True where frames run as CUDA graphs: on a CUDA device, outside
    kernels.plain_kernels()."""
    return torch.device(device).type == "cuda" and not kernels.plain_kernels_active()


def _map(out, f):
    """f over a tensor or over the tensors of a dict."""
    return f(out) if isinstance(out, torch.Tensor) else {k: f(v) for k, v in out.items()}


class Graph:
    """fn(*inputs) -> a tensor or a dict of tensors, with n tensor inputs,
    captured on the first call and replayed on the later ones (module
    docstring). After the capture, ``inputs`` are the static input buffers,
    ``capture_ms`` is the host time of the first call, the eager call (with
    the kernels' build) and the capture (the ``setup.capture`` span,
    tracing.py), ``pool_bytes`` the device memory the graph's pool reserved
    and ``launches`` the kernel launches of one replay."""

    def __init__(self, fn, name: str = "graph"):
        self.fn = fn
        self.name = name
        self.capture_ms: float | None = None
        self.pool_bytes: int | None = None
        self.launches: dict[str, int] = {}
        self.frames: dict = {}  # tracing.FrameMarks -> frames a replay counts
        self.inputs: tuple[torch.Tensor, ...] | None = None
        self._graph: torch.cuda.CUDAGraph | None = None
        self._device: torch.device | None = None
        self._outputs = None

    def __call__(self, *inputs):
        return self._run(inputs[0].device if inputs else None, self.fn, inputs)

    def _run(self, device, fn, inputs):
        if device is None or device.type != "cuda":
            raise ValueError(f"{self.name}: a CUDA graph needs a CUDA device, the inputs are on {device}")
        if kernels.plain_kernels_active():
            return fn(*inputs)
        if self._graph is None:
            return self._capture(device, fn, inputs)
        if len(inputs) != len(self.inputs) or any(
            x.shape != s.shape or x.dtype != s.dtype for x, s in zip(inputs, self.inputs)
        ):
            raise ValueError(f"{self.name}: the inputs differ in number, shape or dtype from the captured ones")
        with torch.cuda.device(self._device):
            for x, s in zip(inputs, self.inputs):
                if x is not s:
                    s.copy_(x, non_blocking=True)
            self.replay()
            return _map(self._outputs, torch.Tensor.clone)

    def replay(self) -> None:
        """Replay the captured graph on its static inputs, its outputs left
        in the graph's own buffers, and count what it launched: kernels
        (kernels.LAUNCHES) and frames (tracing.FrameMarks.enqueued)."""
        self._graph.replay()
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n
        for m, n in self.frames.items():
            m.count(n)

    def _capture(self, device, fn, inputs):
        span = tracing.SETUP_CAPTURE.begin()
        try:
            first = self._eager_and_capture(device, fn, inputs)
        finally:
            ns = tracing.SETUP_CAPTURE.end(span)
        self.capture_ms = ns / 1e6
        return first

    def _eager_and_capture(self, device, fn, inputs):
        with torch.cuda.device(device):
            static = tuple(
                torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=device).copy_(x) for x in inputs
            )
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                first = fn(*static)
            current.wait_stream(side)
            _map(first, lambda v: v.record_stream(current))

            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            before = dict(kernels.LAUNCHES)
            frames_before = tracing.enqueued()
            graph = torch.cuda.CUDAGraph()
            try:
                # A capture stream of the graph's device: torch.cuda.graph's
                # default one belongs to the device current at its first use.
                with torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
                    outputs = fn(*static)
            except RuntimeError as e:
                raise RuntimeError(f"{self.name}: CUDA graph capture failed: {e}") from e
            finally:
                counted = {k: kernels.LAUNCHES[k] - before[k] for k in before}
                kernels.LAUNCHES.update(before)
                self.frames = {m: m.enqueued - n for m, n in frames_before.items() if m.enqueued != n}
                for m, n in self.frames.items():
                    m.count(-n)
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = {k: n for k, n in counted.items() if n}
        self._graph, self._device, self.inputs, self._outputs = graph, device, static, outputs
        return first

    def close(self) -> None:
        """Drop the graph, its static tensors and so its pool; the next call
        captures again."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._device = self.inputs = self._outputs = None


class FrameGraph(Graph):
    """The Graph of fn(scene, view_proj, camera_position) -> dict of
    tensors, on the scene's device, with view_proj (4, 4) and
    camera_position (3,) its inputs: the uniforms may come from another
    card. The scene is held, not copied: later calls must pass the scene
    of the capture."""

    def __init__(self, fn, name: str = "frame"):
        super().__init__(fn, name)
        self._scene = None

    def __call__(self, scene, view_proj, camera_position) -> dict:
        if self._graph is not None and scene is not self._scene and not kernels.plain_kernels_active():
            raise ValueError(f"{self.name}: the graph was captured on another scene")
        out = self._run(scene["corner_world"].device, functools.partial(self.fn, scene), (view_proj, camera_position))
        if self._graph is not None:
            self._scene = scene
        return out

    def close(self) -> None:
        super().close()
        self._scene = None
