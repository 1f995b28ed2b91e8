"""Engine: the app framework (tpurast/engine.py, headless).

Owns the renderer, the scene, the fly camera, the frame loop and frame
statistics. Input arrives as per-tick ``MoveDirection`` + mouse deltas; a
scripted ``controller`` drives flythroughs.

Startup mirrors the reference's Engine.init: the 4-model demo scene with
its placements when given a data directory (or any prebuilt scene), the
camera at -2.5 * forward looking at +forward, a 1280x720 default target.
The engine renders on ``device``: "cuda" (the default) launches the CUDA
kernels, "cpu" runs their plain torch versions. ``trace`` (the default)
traces its Renderer (tracing.py) and reads each frame's counters from the
trace's counter ring.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

import numpy as np

from tpurast_torch import math3d
from tpurast_torch.camera import Camera, MoveDirection
from tpurast_torch.config import RendererConfig
from tpurast_torch.device.scene import DeviceScene, load_demo_scene
from tpurast_torch.overlay import FrameStats, draw_frametime_overlay
from tpurast_torch.present import Presenter
from tpurast_torch.renderer import Renderer

log = logging.getLogger("tpurast_torch.engine")

#: controller(frame_index, engine) -> (MoveDirection, (mouse_dx, mouse_dy))
Controller = Callable[[int, "Engine"], tuple[MoveDirection, tuple[float, float]]]


class Engine:
    MAX_TIMESTEP = 0.25  # seconds; see tick()

    def __init__(
        self,
        data_dir: str | None = None,
        scene: DeviceScene | None = None,
        config: RendererConfig | None = None,
        overlay: bool = True,
        *,
        device="cuda",
        trace: bool = True,
    ):
        self.config = config or RendererConfig()
        if scene is None:
            if data_dir is None:
                raise ValueError("need data_dir or a prebuilt scene")
            scene = load_demo_scene(data_dir)
        self.renderer = Renderer(scene, self.config, device=device, trace=trace)
        fwd = math3d.WORLD_SPACE.forward.vector()
        self.camera = Camera.from_target(fwd * -2.5, fwd)
        self.presenter = Presenter()
        self.stats = FrameStats()
        self.overlay_enabled = overlay
        # The reference's single runtime toggle (its VSync checkbox):
        # cap the loop at 60 Hz when enabled.
        self.vsync = False
        self._last_instant: float | None = None
        # Overflow surfacing. Traced: each tick reads bin_overflow and
        # window_miss_px of every frame the card has finished since the
        # last read from the counter ring (tracing.FrameMarks.counters),
        # which waits for nothing; a frame still in flight is read by a
        # later tick, or by run()'s end. Untraced: the previous frame's
        # scalars are read one tick late with .item(), which copies behind
        # the frame just enqueued and so waits for that frame to finish.
        marks = self.renderer.marks
        self._counted = 0 if marks is None else marks.enqueued
        self._pending_overflow = None
        self._pending_window_miss = None
        self.overflow_frames = 0
        self.dropped_total = 0
        self.window_miss_total = 0
        self.frame_index = 0

    # -- one tick: update + render + present ------------------------------
    def tick(
        self,
        move: MoveDirection = MoveDirection(),
        mouse_delta: tuple[float, float] = (0.0, 0.0),
    ) -> np.ndarray | None:
        """Advance one frame. Returns the *previous* frame's host image
        (double-buffered present), None on the first tick."""
        now = time.perf_counter()
        dt = 0.0 if self._last_instant is None else now - self._last_instant
        self._last_instant = now
        # Max-timestep clamp: the first frames pay the kernels' build and
        # the device's start-up (seconds); without a clamp a scripted
        # flythrough teleports. Not a behavior change at 60 Hz.
        dt = min(dt, self.MAX_TIMESTEP)

        # Update: move then mouse look.
        if dt > 0.0:
            self.camera = self.camera.translate(dt, move)
        if mouse_delta != (0.0, 0.0):
            self.camera = self.camera.update_orientation(*mouse_delta)

        frame = self.renderer.render(self.camera)
        image = self.presenter.present(frame["color"])
        if self.renderer.marks is not None:
            self._read_counter_ring(self.frame_index)
        else:
            # The PREVIOUS frame's counters (this frame is already
            # enqueued behind them).
            if self._pending_overflow is not None:
                self._account(self.frame_index - 1, int(self._pending_overflow.item()), 0)
            if self._pending_window_miss is not None:
                self._account(self.frame_index - 1, 0, int(self._pending_window_miss.item()))
            self._pending_overflow = frame["bin_overflow"]
            self._pending_window_miss = frame.get("window_miss_px")
        if self.vsync:
            budget = 1.0 / 60.0
            elapsed = time.perf_counter() - now
            if elapsed < budget:
                time.sleep(budget - elapsed)
        after = time.perf_counter()
        self.stats.record(after - now)
        self.frame_index += 1

        if image is not None and self.overlay_enabled:
            image = draw_frametime_overlay(image, self.stats.last_ms)
        return image

    def _account(self, index: int, dropped: int, missed: int) -> None:
        if dropped:
            self.overflow_frames += 1
            self.dropped_total += dropped
            log.warning("frame %d: %d binned pairs dropped (more huge faces than the binner's budget)",
                        index, dropped)
        if missed:
            self.window_miss_total += missed
            log.warning("frame %d: %d pixels lie in tiles that need more texel windows than the plan holds "
                        "(unwindowable UV layout); the frame is correct", index, missed)

    def _read_counter_ring(self, newest: int) -> None:
        """Account the counters of the frames the card has finished since
        the last read, in order; ``newest`` is the frame index of the last
        frame enqueued."""
        marks = self.renderer.marks
        while self._counted < marks.enqueued:
            counters = marks.counters(self._counted + 1)
            if counters is None:
                break
            self._counted += 1
            self._account(newest - (marks.enqueued - self._counted), *counters)

    def run(
        self,
        num_frames: int,
        controller: Controller | None = None,
        on_frame: Callable[[int, np.ndarray], None] | None = None,
    ) -> np.ndarray:
        """Run the frame loop. Returns the final presented frame."""
        last = None
        for i in range(num_frames):
            move, mouse = (
                controller(i, self) if controller else (MoveDirection(), (0.0, 0.0))
            )
            image = self.tick(move, mouse)
            if image is not None:
                last = image
                if on_frame:
                    on_frame(i, image)
        tail = self.presenter.flush()
        if self.renderer.marks is not None:  # the last frame has finished
            self._read_counter_ring(self.frame_index - 1)
        if tail is not None:
            tail_img = np.asarray(tail)
            if self.overlay_enabled:
                tail_img = draw_frametime_overlay(tail_img, self.stats.last_ms)
            last = tail_img
            if on_frame:
                on_frame(num_frames, last)
        log.info(
            "ran %d frames: p50 %.3f ms (%.1f FPS)",
            num_frames,
            self.stats.p50_ms,
            self.stats.fps,
        )
        return last

    # -- resize -----------------------------------------------------------
    def resize(self, width: int, height: int) -> None:
        self.renderer.recreate_swapchain(width, height)
