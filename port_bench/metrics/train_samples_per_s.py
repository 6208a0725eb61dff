"""Samples of the steps completed in the window (batch × steps), over the
window, whose clock stops once the last step's loss is on the host."""


def read(run):
    w = run.window
    return w["samples"] / w["elapsed_s"] if w["completed"] else None
