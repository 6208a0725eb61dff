"""Profiling hooks of the port (counterpart of `waveformer_tpu/utils/profiling.py`).

  * `trace(logdir)` — context manager around `torch.profiler` (CPU and, where
    there is a card, CUDA activity) writing a Chrome trace into `logdir`
    (open with Perfetto or `chrome://tracing`);
  * `Timer` — hierarchical wall-clock section timers with summaries;
  * `device_time` — seconds per call of a callable, timed on the device: CUDA
    events around calls queued behind a device sleep for CUDA tensors, the
    host clock for CPU ones;
  * `estimate_flops` — PyTorch's FLOP counter over one call.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: `with trace('./profile'): step(...)`; the Chrome trace
    goes to `logdir/trace_<pid>_<ns>.json`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer:
    """Named wall-clock sections with mean/total summaries."""

    def __init__(self):
        self._acc: Dict[str, list] = collections.defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "mean_s": float(np.mean(v)),
                "total_s": float(np.sum(v)),
                "count": len(v),
            }
            for k, v in self._acc.items()
        }

    def report(self) -> str:
        lines = []
        for k, s in sorted(self.summary().items()):
            lines.append(
                f"{k:30s} mean {s['mean_s'] * 1000:8.2f} ms  "
                f"total {s['total_s']:8.2f} s  (n={s['count']})"
            )
        return "\n".join(lines)


def _first_tensor(out) -> torch.Tensor:
    while isinstance(out, (list, tuple)):
        out = out[0]
    return out


# device clocks of sleep queued ahead of each timed CUDA call (≈0.6 ms at the
# H100's clock): more than the host needs to launch any call timed here
SLEEP_CYCLES = 1_000_000


def device_time(fn: Callable, *args, iters: int = 8, behind_sleep: bool = True) -> float:
    """Seconds per call of `fn(*args)`, the first argument perturbed by
    `i·1e-6` on call `i` (as the JAX helper's scan carry does), after one
    warm-up call; one scalar of the last output is read back at the end.

    For a CUDA first argument the `iters` perturbed inputs are made on the
    device before the start event, and CUDA events around the calls give the
    time; the calls are queued behind a device-side sleep of `SLEEP_CYCLES`
    per call, so a call that is shorter than its host work (wrapper, tensor
    maps, launches) is timed on the device, not at the host's launch rate.
    `behind_sleep=False` leaves the sleep out: the calls then run back to
    back as the host issues them, and a call bound by its host work is
    timed at the host's rate. For a CPU first argument, the host clock
    around the calls.
    """
    first, rest = args[0], args[1:]
    inputs = [(first + i * 1e-6).to(first.dtype) for i in range(iters)]
    out = fn(*args)  # warm-up (and, for a kernel, its build)
    if first.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(first.device)
        if behind_sleep:
            torch.cuda._sleep(SLEEP_CYCLES * iters)
        start.record()
        for a in inputs:
            out = fn(a, *rest)
        end.record()
        float(_first_tensor(out).reshape(-1)[0])
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for a in inputs:
        out = fn(a, *rest)
    float(_first_tensor(out).reshape(-1)[0])
    return (time.perf_counter() - t0) / iters


def estimate_flops(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call of `fn(*args)` by `torch.utils.flop_counter` (None
    where the counter counts nothing, e.g. a call made only of kernels of
    this package, which it does not see)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    total = counter.get_total_flops()
    return float(total) if total else None
