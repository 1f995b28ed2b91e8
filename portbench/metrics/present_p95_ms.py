"""present_p95_ms (ms): the 95th percentile of the host-clock intervals
between consecutive hand-outs, over every frame of the window. A per-layer
metric: it spreads by 15-31% from run to run, more than any end-to-end
bound allows (PERF.md)."""

import numpy as np

UNIT = "ms"


def read(run):
    return float(np.percentile(run.window.intervals_ms, 95))
