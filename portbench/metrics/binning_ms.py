"""binning_ms (ms): pair binning (geometry.bin_pairs / bin_triangles), from
the mark after geometry to the mark after binning (the program's own trace,
tpurast_torch/tracing.py, on the card's clock), mean over the untraced
window's frames."""

from portbench import program_trace

UNIT = "ms"


def read(run):
    return program_trace.mark_interval_ms(run, "geometry", "binning")
