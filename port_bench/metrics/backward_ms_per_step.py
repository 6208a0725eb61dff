"""Device ms a step between the CUDA events of the system's
`train_step.backward` span: the backward and the fp32 gradients' list."""

from port_bench.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "train_step.backward")
