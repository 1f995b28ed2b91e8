"""setup_s (s): the host clock from the run's first line to the window's
start: the inputs made from the seed, the program's scene built and
uploaded, its kernels built where the checkout has not, the frame's CUDA
graph captured and the loop warmed up."""

UNIT = "s"


def read(run):
    return run.setup_s
