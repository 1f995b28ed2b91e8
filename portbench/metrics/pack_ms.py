"""pack_ms (ms): the per-face attribute pack (resolve.pack_resolve_attrs, or
shade.pack_shade_rows on the deferred path), from the mark at raster's end to
the mark after the pack (the program's own trace,
tpurast_torch/tracing.py, on the card's clock), mean over the untraced
window's frames."""

from portbench import program_trace

UNIT = "ms"


def read(run):
    return program_trace.mark_interval_ms(run, "raster", "pack")
