"""The traced window: `torch.profiler` over a run's traffic, reduced to what
the per-layer metrics read.

  * every device activity (kernels, copies, sets) with its start, length
    and whether it was launched inside a span of the benchmark's own
    (`span`, around the callables it hands to the program);
  * `busy_s`: the union of the device activities' intervals within the
    window; the idle gaps between them, each named by the innermost host
    operation running when it began;
  * the top device operations by time and the idle seconds by host
    operation, for `breakdown`.

A launch (a graph's launch included) is tied to its device activities by
the CUPTI correlation id they carry; where under 95% of the activities are
tied, the trace is not `attributed` and the metrics that read the spans
are left out. The kernel categories are a frozen copy of the program's
`trace_forward.CATEGORIES`.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

MODEL_SPAN = "port_bench.model"
LOSS_SPAN = "port_bench.loss"
WINDOW_SPAN = "port_bench.window"

# first matching substring of the lower-cased kernel name wins
CATEGORIES = [
    ("window_attention", ("window_attention",)),
    ("dwconv3", ("dwconv3",)),
    ("sdpa", ("flash", "fmha", "efficient_attention")),
    ("optimizer_foreach", ("multi_tensor",)),
    ("conv", ("conv", "cudnn", "implicit", "xmma_fprop", "dgrad", "wgrad", "winograd")),
    ("matmul", ("gemm", "cutlass", "matmul", "nvjet", "sm90_xmma")),
    ("norm_reduce", ("norm", "reduce", "welford", "var_mean", "softmax")),
    ("resize", ("upsample", "interp")),
    ("copy", ("copy", "memcpy", "memset", "cat", "flip", "index", "gather", "pad")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "gelu", "leaky", "sigmoid")),
]


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


class Span:
    """A callable of the program wrapped in a named profiler range, with a
    count of its calls and of the rows (leading dimension) they took."""

    def __init__(self, name: str, fn):
        self.name, self.fn = name, fn
        self.calls = 0
        self.rows = 0

    def __call__(self, x, *args, **kwargs):
        self.calls += 1
        self.rows += int(x.shape[0])
        with torch.profiler.record_function(self.name):
            return self.fn(x, *args, **kwargs)


@dataclass
class Activity:
    name: str
    start: int  # ns
    dur: int  # ns
    spans: Tuple[str, ...] = ()


@dataclass
class Trace:
    window_s: float
    busy_s: float
    activities: List[Activity]
    gaps: List[Tuple[str, float]]  # (host op, seconds)
    attributed: bool  # activities carry the spans they were launched in
    extra: Dict = field(default_factory=dict)

    def device_s(self, span: str, inside: bool = True) -> float:
        """Device seconds of the activities launched inside (or outside)
        `span`."""
        return sum(a.dur for a in self.activities if (span in a.spans) == inside) / 1e9

    def breakdown(self, n: int = 10) -> Dict[str, List]:
        by_kernel: Dict[str, float] = {}
        for a in self.activities:
            key = f"{category(a.name)}: {a.name[:160]}"
            by_kernel[key] = by_kernel.get(key, 0.0) + a.dur / 1e9
        by_host: Dict[str, float] = {}
        for name, s in self.gaps:
            by_host[name] = by_host.get(name, 0.0) + s
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in idle]}


@contextlib.contextmanager
def profiled():
    """Profile the block on the CPU and the CUDA device; yields a dict that
    holds the `Trace` once the block has ended. The block is the window:
    it has to end with the device's work done (a read-back or a
    synchronise)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out: Dict = {}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_SPAN):
            yield out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out["trace"] = reduce(prof.profiler.kineto_results.events(), window_s)


_LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
           "cudaGraphLaunch", "cuGraphLaunch",
           "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def reduce(events, window_s: float, span_names=(MODEL_SPAN, LOSS_SPAN)) -> Trace:
    """The `Trace` of a window from the profiler's kineto events."""
    host, device = [], []
    for e in events:
        if not _is_device(e):
            host.append(e)
        elif not e.is_user_annotation():
            device.append(e)
    window = [e for e in host if e.name() == WINDOW_SPAN]
    w0, w1 = window[0].start_ns(), window[0].end_ns()

    spans = {n: sorted((e.start_ns(), e.end_ns()) for e in host if e.name() == n)
             for n in span_names}
    launches = {e.correlation_id(): e.start_ns() for e in host
                if e.name() in _LAUNCH and e.correlation_id()}
    acts = []
    tied = 0
    for e in device:
        ts = launches.get(e.correlation_id())
        tied += ts is not None
        inside = tuple(n for n, iv in spans.items() if ts is not None and _covers(iv, ts))
        acts.append(Activity(e.name(), e.start_ns(), e.duration_ns(), inside))
    attributed = bool(device) and tied >= 0.95 * len(device)

    busy, gaps_iv = _union_and_gaps([(a.start, a.start + a.dur) for a in acts], w0, w1)
    ops = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in host
                  if e.name() not in (WINDOW_SPAN,)), key=lambda t: t[0])
    starts = [o[0] for o in ops]
    gaps = []
    for g0, g1 in gaps_iv:
        gaps.append((_innermost(ops, starts, g0), (g1 - g0) / 1e9))
    return Trace(window_s=window_s, busy_s=busy / 1e9, activities=acts, gaps=gaps,
                 attributed=attributed,
                 extra={"device_ops": len(device), "tied": tied, "host_ops": len(host)})


def _covers(intervals, t) -> bool:
    """Whether t lies in one of the sorted, disjoint `intervals`."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][1] >= t


def _union_and_gaps(intervals, w0, w1):
    busy, gaps = 0, []
    cur = w0
    for s, e in sorted(intervals):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def _innermost(ops, starts, t) -> str:
    """The host operation running at time t that began last: the innermost
    of a thread's nested operations."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 200, -1), -1):
        s, e, name = ops[j]
        if e >= t:
            return name
    return "(python)"
