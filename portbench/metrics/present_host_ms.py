"""present_host_ms (ms): the host's time inside Presenter.present a frame
(the harness's clock around the call: the interleave and copy start of
this frame, the wait for and copy out of the last one), mean over the
window of the present loop."""

UNIT = "ms"


def read(run):
    return run.window.present_host_ms
