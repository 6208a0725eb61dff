"""Ms a case in which the device ran nothing while the host was inside the
system's `predictor.upload` span: each span's interval less the union of
the trace's device activities within it, on the profiler's one clock."""

from port_bench.spans import idle_ms_per_case


def read(run):
    return idle_ms_per_case(run, "predictor.upload")
