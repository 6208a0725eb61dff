"""Device ms a case in the Swin blocks' window shuffle: the time between
the CUDA events at the entry and exit of the system's `swin.window_shuffle`
spans (each block's zero padding, cyclic shift and window partition, and
its inverse, shift back and crop), summed over the traced window, over the
cases it completed."""

from port_bench.spans import recorded


def read(run):
    found = recorded("swin.window_shuffle") if run.trace is not None else None
    ms = [s["device_ms"] for s in found or () if s["device_ms"] is not None]
    return sum(ms) / run.window["completed"] if ms and run.window["completed"] else None
