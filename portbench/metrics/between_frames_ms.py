"""between_frames_ms (ms): from a frame's last mark to the next frame's
first (the program's own trace, on the card's clock): the output clones, the
next frame's uniform copies and whatever idle the card sees between frames,
mean over the untraced window's frames."""

from portbench import program_trace

UNIT = "ms"


def read(run):
    return program_trace.between_frames_ms(run)
