"""cut_faces (faces): the faces cut by the eye plane that the binner ranges
by their near-plane box and that name at least one tile (geometry.bin_pairs
cut_faces, counted on the card by csrc/bin.cu and written into the frame's
record by its last mark; the program's own trace, tpurast_torch/tracing.py),
mean a frame over the untraced window's frames. None where the program's
records carry no such count."""

import numpy as np

from portbench import program_trace

UNIT = "faces"


def read(run):
    f = program_trace.window_records(run)
    if f is None or "cut" not in f:
        return None
    return float(np.mean(f["cut"]))
