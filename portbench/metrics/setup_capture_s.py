"""setup_capture_s (s): the frame graph's first call (graphs.py, the
setup.capture span inside the first ``frame`` span): the eager frame, with
the kernels' nvcc build where the checkout has none, and the capture, host
clock."""

from portbench import program_trace

UNIT = "s"


def read(run):
    return program_trace.setup_span_s(run, "setup.capture", parent="frame")
