"""Device ms a step between the CUDA events of the system's
`train_step.forward` span: the module's forward and the loss."""

from port_bench.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "train_step.forward")
