"""Device ms a step between the CUDA events of the system's
`train_step.optimizer` span: the clip, AdamW on the fp32 masters and
their copy into the module."""

from port_bench.spans import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "train_step.optimizer")
