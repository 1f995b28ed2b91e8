"""encode_ms (ms): the depth crop and the sRGB encode (kernels/present.py),
from the mark at the last shading kernel's end to the frame's last mark (the program's own trace,
tpurast_torch/tracing.py, on the card's clock), mean over the untraced
window's frames."""

from portbench import program_trace

UNIT = "ms"


def read(run):
    return program_trace.mark_interval_ms(run, "shading", "encode")
