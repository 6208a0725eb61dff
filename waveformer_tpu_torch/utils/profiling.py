"""Profiling hooks of the port (counterpart of `waveformer_tpu/utils/profiling.py`).

  * `trace(logdir)` — context manager around `torch.profiler` (CPU and, where
    there is a card, CUDA activity) writing a Chrome trace into `logdir`
    (open with Perfetto or `chrome://tracing`);
  * `span(name, case=None, device=False)` — a named range of the program's
    own (the case driver's upload, dispatch and read-back; the training
    step's forward, backward and optimizer), recorded only while a
    `torch.profiler` runs: in `trace`'s Chrome trace it lies on the host
    timeline above the device work it launched, and `spans()` gives the
    ranges of the last such block with their case ids, on the profiler's
    clock (`time.time_ns()`), and the device ms of those opened with
    `device=True`;
  * `device_time` — seconds per call of a callable, timed on the device: CUDA
    events around calls queued behind a device sleep for CUDA tensors, the
    host clock for CPU ones.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Callable, Dict, List

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: `with trace('./profile'): step(...)`; the Chrome trace
    goes to `logdir/trace_<pid>_<ns>.json`, and `spans()` gives the block's
    spans afterwards."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _RECORD.clear()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# the spans recorded while a profiler ran, oldest dropped first
_RECORD: collections.deque = collections.deque(maxlen=4096)
_IDS = itertools.count()
_OPEN = threading.local()  # .stack: the ids of this thread's open spans
_OFF = contextlib.nullcontext()


class _Span:
    """An open span: a `record_function` range of the same name, and on
    exit one entry of the record."""

    __slots__ = ("name", "case", "id", "parent", "range", "events", "start")

    def __init__(self, name: str, case, device: bool):
        self.name, self.case = name, case
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if device and torch.cuda.is_available() else None)

    def __enter__(self):
        stack = _OPEN.__dict__.setdefault("stack", [])
        self.id, self.parent = next(_IDS), (stack[-1] if stack else None)
        stack.append(self.id)
        # the host's times enclose the range's, which its entry's first call
        # can delay by most of a millisecond
        self.start = time.time_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        end = time.time_ns()
        _OPEN.stack.pop()
        _RECORD.append({"name": self.name, "case": self.case, "id": self.id,
                        "parent": self.parent, "start_ns": self.start, "end_ns": end,
                        "thread": threading.get_ident(), "events": self.events})
        return False


def span(name: str, case=None, device: bool = False):
    """A context manager bracketing one step of the program. While no
    `torch.profiler` runs it is a shared null context and records nothing.
    While one runs, the block is a `record_function(name)` range and, on
    exit, an entry of the record: `name`, `case` (the request's id: spans
    of one case share it), `id`, `parent` (the id of the innermost span
    open on this thread when it began), `start_ns` / `end_ns` from
    `time.time_ns()` (the clock of the profiler's events) and `thread`;
    with `device`, CUDA events on the current stream at entry and exit."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, case, device)


def spans() -> List[Dict]:
    """The recorded spans, oldest first, each with `device_ms` (the time
    between its CUDA events, or None); waits once for the device if any
    span has events."""
    record = list(_RECORD)
    if any(r["events"] is not None for r in record):
        torch.cuda.synchronize()
    out = []
    for r in record:
        entry = {k: v for k, v in r.items() if k != "events"}
        ev = r["events"]
        entry["device_ms"] = ev[0].elapsed_time(ev[1]) if ev is not None else None
        out.append(entry)
    return out


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

