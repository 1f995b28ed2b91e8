"""The timed loops: a viewer rendering back to back, and its present loop.

Both are closed loops: the next frame is asked for as soon as the last
call returns, as a viewer does, with a new pose from the track every
frame. Nothing in the window synchronizes with the card: completion is
marked by a CUDA event recorded after each frame (on the CPU, where the
tests run the loops with the program's plain versions, by the host's
clock after each call), the program's counters are kept as the device
tensors it returns, and a seeded reservoir keeps a sample of the frames
for the comparison with the reference once the window has closed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import numpy as np
import torch


class Marks:
    """Completion marks: CUDA events on the card's current stream, the
    host clock on the CPU. intervals_ms() are the gaps between marks."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> np.ndarray:
        if self.cuda:
            return np.array([a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])])
        return np.diff(np.array(self.marks)) * 1e3


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``
    (Algorithm R): the same seed and count give the same sample."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class Window:
    frames: int  # frames completed (render) or handed to the host (present)
    seconds: float  # host clock from the window's start to its last frame's completion
    intervals_ms: np.ndarray  # between consecutive completions (render) or hand-outs (present)
    render_host_ms: float  # mean host ms in render_with_uniforms
    present_host_ms: float | None  # mean host ms in Presenter.present
    overflow: list  # each frame's bin_overflow, as the program returned it
    sample: list  # (pose index, frame) pairs the reservoir kept


def no_span(name: str):
    return contextlib.nullcontext()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_window(renderer, cams, start: int, seconds: float, reservoir: Reservoir, span=no_span,
                  frames: int | None = None) -> Window:
    """Frames back to back for ``seconds`` of the host clock (at least one),
    or for ``frames`` frames."""
    dev = renderer.device
    marks = Marks(dev)
    overflow, host = [], 0.0
    _sync(dev)
    t0 = time.perf_counter()
    marks.mark()
    k = 0
    while True:
        pose = (start + k) % len(cams)
        with span("uniforms"):
            vp, cp = renderer.frame_uniforms(cams[pose])
        with span("render_call"):
            h0 = time.perf_counter()
            out = renderer.render_with_uniforms(vp, cp)
            h1 = time.perf_counter()
        marks.mark()
        host += h1 - h0
        overflow.append(out["bin_overflow"])
        reservoir.offer((pose, out["color"]))
        k += 1
        if h1 - t0 >= seconds or k == frames:
            break
    _sync(dev)
    t1 = time.perf_counter()
    return Window(frames=k, seconds=t1 - t0, intervals_ms=marks.intervals_ms(), render_host_ms=host / k * 1e3,
                  present_host_ms=None, overflow=overflow, sample=reservoir.items)


def present_window(renderer, presenter, cams, start: int, seconds: float, reservoir: Reservoir, span=no_span,
                   frames: int | None = None) -> Window:
    """Frames rendered and handed to the host through the Presenter for
    ``seconds`` (or ``frames`` frames), then the last one drained: what a
    viewer's user sees."""
    dev = renderer.device
    overflow, host_r, host_p = [], 0.0, 0.0
    handed: list[float] = []
    _sync(dev)
    t0 = time.perf_counter()
    k = 0
    while True:
        pose = (start + k) % len(cams)
        with span("uniforms"):
            vp, cp = renderer.frame_uniforms(cams[pose])
        with span("render_call"):
            h0 = time.perf_counter()
            out = renderer.render_with_uniforms(vp, cp)
            h1 = time.perf_counter()
        with span("present"):
            img = presenter.present(out["color"])
            h2 = time.perf_counter()
        host_r += h1 - h0
        host_p += h2 - h1
        overflow.append(out["bin_overflow"])
        if img is not None:
            handed.append(h2)
            reservoir.offer(((start + k - 1) % len(cams), img))
        k += 1
        if h2 - t0 >= seconds or k == frames:
            break
    with span("present"):
        img = presenter.flush()
    t1 = time.perf_counter()
    handed.append(t1)
    reservoir.offer(((start + k - 1) % len(cams), img))
    return Window(frames=len(handed), seconds=t1 - t0, intervals_ms=np.diff(np.array([t0] + handed)) * 1e3,
                  render_host_ms=host_r / k * 1e3, present_host_ms=host_p / k * 1e3, overflow=overflow,
                  sample=reservoir.items)


def warm_up(renderer, cams, start: int, frames: int, presenter=None) -> None:
    """The first call renders eagerly and captures the frame's CUDA graph
    (building the kernels if this checkout has not); the rest replay it,
    through the Presenter where the loop presents."""
    for k in range(frames):
        out = renderer.render(cams[(start + k) % len(cams)])
        if presenter is not None:
            presenter.present(out["color"])
    if presenter is not None:
        presenter.flush()
    _sync(renderer.device)
