"""frame_p95_ms (ms): the 95th percentile, over every frame of the window,
of the interval between consecutive frames' completion (CUDA events
recorded after each frame, the window's start the first)."""

import numpy as np

UNIT = "ms"


def read(run):
    return float(np.percentile(run.window.intervals_ms, 95))
