"""Device ms a case in the Swin encoder: the time between the CUDA events
at the entry and exit of the system's `swin.encoder` spans (each forward's
patch embedding, stage conv blocks, Swin blocks and patch merging),
summed over the traced window, over the cases it completed. The events
lie on the stream the forward runs on; with the card busy, the time
between them is the device's work on the span."""

from port_bench.spans import recorded


def read(run):
    found = recorded("swin.encoder") if run.trace is not None else None
    ms = [s["device_ms"] for s in found or () if s["device_ms"] is not None]
    return sum(ms) / run.window["completed"] if ms and run.window["completed"] else None
