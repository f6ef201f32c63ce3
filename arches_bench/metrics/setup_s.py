"""Process start to the first timed campaign: the kernels' load (and on a
checkout's first run their build), the policy's profiling and fit, and one
campaign at the cell's shapes."""


def read(run):
    return run.setup_s
