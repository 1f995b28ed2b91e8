"""frame_ms (ms/frame): the whole window on the host clock, from its start
to the last frame's completion, over the frames rendered in it."""

UNIT = "ms/frame"


def read(run):
    return run.window.seconds * 1e3 / run.window.frames
