"""present_copy_ms (ms): the Presenter's copy of the frame it hands out, out
of pinned memory into the caller's image (the program's present.copy span,
host clock), mean over the untraced window (under the traced slice's
profiler the host slows)."""

from portbench import program_trace

UNIT = "ms"


def read(run):
    return program_trace.window_span_ms(run, "present.copy")
