"""torch_ops_ms (ms/frame): device time of every operation in the traced
slice that is not one of the port's own kernels (portbench/kernels.json):
the geometry and binning, the attribute or shade-row pack, the encode and
the copies, as torch runs them, per frame."""

UNIT = "ms/frame"


def read(run):
    return None if run.reading is None else run.reading.other_ms
