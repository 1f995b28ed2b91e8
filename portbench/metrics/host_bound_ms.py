"""host_bound_ms (ms): a frame, max(0, the end of the next frame's ``frame``
span - this frame's last mark): how long the card has run dry while the host
had not yet enqueued the next frame (the program's own trace, the card's
marks mapped onto the host's clock), mean over the frames of the untraced
window that the program's ring still holds (under the traced slice's
profiler the host slows)."""

import numpy as np

from portbench import program_trace

UNIT = "ms"


def read(run):
    w = program_trace.window(run)
    f = None if w is None else program_trace.records(run, *w)
    s = None if w is None else program_trace.frame_spans(run, "frame", *w)
    if f is None or s is None:
        return None
    end = dict(zip(s["frame"].tolist(), s["end_ns"].tolist()))
    last = dict(zip(f["seq"].tolist(), f["t_ns"][:, -1].tolist()))
    gaps = [max(0, end[q + 1] - t) for q, t in last.items() if q + 1 in end and q + 1 <= w[1]]
    return float(np.mean(gaps)) / 1e6 if gaps else None
