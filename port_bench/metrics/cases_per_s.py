"""Cases whose label map reached the host, over the time from the window's
first submission to its last completion."""


def read(run):
    w = run.window
    return w["completed"] / w["elapsed_s"] if w["completed"] else None
