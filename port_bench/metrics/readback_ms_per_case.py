"""Host ms a case inside the system's `predictor.readback` span: the wait
for the case's label map on the device and its copy to the host."""

from port_bench.spans import host_ms_per_case


def read(run):
    return host_ms_per_case(run, "predictor.readback")
