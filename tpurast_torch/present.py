"""Double-buffered device->host framebuffer read-back.

Counterpart of tpurast/present.py: while the device renders frame N, frame
N-1's color buffer travels to the host. ``Presenter.present(frame_n)``
returns frame n-1 as an (H, W, 4) numpy image (None on the first call);
``flush()`` drains the last one.

For a CUDA tensor the frame is interleaved to (H, W, 4) on the device (one
small kernel on the render stream), an event is recorded there, and a copy
stream waits for that event and copies the frame into one of two pinned
host buffers with ``non_blocking=True``. The host waits for frame n-1's
copy event only when that frame is handed out, one call later, so the copy
of frame n-1 overlaps the rendering of frame n. The image handed out is a
copy of the pinned buffer and belongs to the caller: the two buffers take
turns, and a view would be overwritten two calls later. The buffers are
allocated anew when the frame's shape or dtype changes. The device copy of
the frame is kept referenced, and marked as in use by the copy stream, until
its event has been waited for, so the caching allocator cannot hand its
memory to the next frame while the copy still reads it.

For a CPU tensor (or a numpy array) there are no streams: the frame is
kept as it is and interleaved when it is handed out, as the reference does.

The hand-out of a CUDA frame records two spans (tracing.py):
``present.wait``, the wait for its copy event, and ``present.copy``, the
copy out of the pinned buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurast_torch import tracing
from tpurast_torch.kernels.present import interleave

__all__ = ["Presenter", "interleave"]


def _interleaved(frame: torch.Tensor) -> torch.Tensor:
    """(4, H, W) -> contiguous (H, W, 4) on the frame's device; any other
    shape as it is (kernels/present.py interleave, on a tensor)."""
    if frame.dim() == 3 and frame.shape[0] == 4:
        return frame.permute(1, 2, 0).contiguous()
    return frame.contiguous()


class Presenter:
    """present(frame_n) -> host image of frame_{n-1} (None on first call)."""

    def __init__(self) -> None:
        # A CPU frame as given, or (pinned buffer, copy event, device frame).
        self._in_flight = None
        self._pinned: list[torch.Tensor | None] = [None, None]
        self._turn = 0
        self._copy_stream: torch.cuda.Stream | None = None

    def _start_copy(self, frame: torch.Tensor):
        staged = _interleaved(frame)
        if self._copy_stream is None or self._copy_stream.device != staged.device:
            self._copy_stream = torch.cuda.Stream(device=staged.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(staged.device))
        buf = self._pinned[self._turn]
        if buf is None or buf.shape != staged.shape or buf.dtype != staged.dtype:
            buf = torch.empty(staged.shape, dtype=staged.dtype, pin_memory=True)
            self._pinned[self._turn] = buf
        self._turn ^= 1
        done = torch.cuda.Event()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            buf.copy_(staged, non_blocking=True)
            done.record(self._copy_stream)
        staged.record_stream(self._copy_stream)
        return buf, done, staged

    @staticmethod
    def _hand_out(entry) -> np.ndarray | None:
        if entry is None:
            return None
        if isinstance(entry, tuple):
            buf, done, _ = entry
            span = tracing.PRESENT_WAIT.begin()
            done.synchronize()
            span = tracing.PRESENT_WAIT.then(span, tracing.PRESENT_COPY)
            image = buf.numpy().copy()
            tracing.PRESENT_COPY.end(span)
            return image
        return interleave(entry.numpy() if isinstance(entry, torch.Tensor) else np.asarray(entry))

    def present(self, device_frame) -> np.ndarray | None:
        if isinstance(device_frame, torch.Tensor) and device_frame.is_cuda:
            entry = self._start_copy(device_frame)
        else:
            entry = device_frame
        previous, self._in_flight = self._in_flight, entry
        return self._hand_out(previous)

    def flush(self) -> np.ndarray | None:
        """Drain the last in-flight frame (end of the run loop)."""
        last, self._in_flight = self._in_flight, None
        return self._hand_out(last)
