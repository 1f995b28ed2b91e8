"""huge_faces_max (faces): the most faces of more than TILES_PER_FACE tiles
in one frame of the untraced window (geometry.bin_pairs huge_faces, counted
on the card by csrc/bin.cu and written into the frame's record by its last
mark; the program's own trace, tpurast_torch/tracing.py): the headroom
against the binner's budget of 64 huge faces, past which pairs drop. None
where the program's records carry no such count."""

import numpy as np

from portbench import program_trace

UNIT = "faces"


def read(run):
    f = program_trace.window_records(run)
    if f is None or "huge" not in f:
        return None
    return float(np.max(f["huge"]))
