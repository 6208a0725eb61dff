"""Host ms a case inside the system's `predictor.upload` span: the host
cast of the volume, its pin and the enqueue of its copy to the device."""

from port_bench.spans import host_ms_per_case


def read(run):
    return host_ms_per_case(run, "predictor.upload")
