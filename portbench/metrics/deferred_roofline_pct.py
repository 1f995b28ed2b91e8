"""deferred_roofline_pct (%): the deferred kernel's share of its roofline: the mean
bound of the reference's frames of the traced slice (portbench/yardstick.py)
over the kernel's mean device time a frame in the slice. Nothing when the
trace holds no such kernel."""

UNIT = "%"


def read(run):
    r = run.reading
    if r is None or not r.layer_ms.get("deferred") or "deferred" not in r.bounds:
        return None
    return 100.0 * r.bounds["deferred"] / r.layer_ms["deferred"]
