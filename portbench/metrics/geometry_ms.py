"""geometry_ms (ms): the corner transform and triangle setup, from the
frame's start mark to the mark after geometry (the program's own trace,
tpurast_torch/tracing.py, on the card's clock), mean over the untraced
window's frames."""

from portbench import program_trace

UNIT = "ms"


def read(run):
    return program_trace.mark_interval_ms(run, "start", "geometry")
