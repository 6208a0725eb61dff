"""Device ms a step of the data line's all-reduce on rank 0: the program's
`GradientReducer.device_ms("data")` (CUDA events around each collective)
over the traced window's steps. The collective runs after the backward,
inside the step's optimizer span, so none of it is hidden behind compute."""


def read(run):
    ms = run.window.get("allreduce_ms") if run.trace is not None else None
    return sum(ms) / len(ms) if ms else None
