"""setup_s: seconds from the process's start to the window's start
(loading, the kernels' build on a checkout's first run, the weights, the
inputs, the warm-up).  Host clock."""


def read(run):
    return run.setup_s
