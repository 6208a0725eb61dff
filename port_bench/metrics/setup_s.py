"""Seconds from the process's start to the window's: the kernels' build
(in a checkout's first run), the weights, the system's objects, the
inputs and the warm-up."""


def read(run):
    return run.setup_s
