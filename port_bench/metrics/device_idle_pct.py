"""Share of the traced window in which no operation ran on the device
(the union of the profiler's device intervals, against the window)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)
