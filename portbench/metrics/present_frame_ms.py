"""present_frame_ms (ms/frame): the whole window on the host clock over the
frames the Presenter handed to the host in it, the last one drained."""

UNIT = "ms/frame"


def read(run):
    return run.window.seconds * 1e3 / run.window.frames
