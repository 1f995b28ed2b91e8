"""present_wait_ms (ms): the Presenter's wait for the copy event of the frame
it hands out (the program's present.wait span, host clock), mean over the
untraced window (under the traced slice's profiler the host slows)."""

from portbench import program_trace

UNIT = "ms"


def read(run):
    return program_trace.window_span_ms(run, "present.wait")
