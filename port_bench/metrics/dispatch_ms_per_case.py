"""Host ms a case inside the system's `predictor.dispatch` span: the
sliding-window inferer's call, the resample and the argmax, enqueued."""

from port_bench.spans import host_ms_per_case


def read(run):
    return host_ms_per_case(run, "predictor.dispatch")
