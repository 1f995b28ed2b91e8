"""device_idle_pct.present (%): device_idle_pct in the present loop, where
the host's hand-out sets the pace."""

UNIT = "%"


def read(run):
    r = run.reading
    if r is None or r.loop != "present":
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
