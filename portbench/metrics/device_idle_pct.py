"""device_idle_pct (%): the share of the traced slice of the render loop in
which no kernel, copy or set ran on the card (the union of the profiler's
device intervals against the slice's span)."""

UNIT = "%"


def read(run):
    r = run.reading
    if r is None or r.loop != "render":
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
