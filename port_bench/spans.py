"""What the readers of the program's own spans share.

The system records its spans (`waveformer_tpu_torch.utils.profiling.span`)
only while a profiler runs: in a traced run, the traced window's. Each has
its name, its case id, its start and end on the profiler's clock
(`time.time_ns()`, the clock of the trace's device activities) and, where
the program asked for them, the device ms between CUDA events at its entry
and exit. A system that records no spans gives None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional


def recorded(name: str) -> Optional[List[Dict]]:
    """The spans named `name` that the system recorded, or None."""
    try:
        from waveformer_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    found = [s for s in spans() if s["name"] == name]
    return found or None


def _per_case(found: List[Dict], ns: float) -> float:
    return ns / 1e6 / len({s["case"] for s in found})


def host_ms_per_case(run, name: str) -> Optional[float]:
    """Host ms inside the spans named `name`, over the cases they name."""
    found = recorded(name) if run.trace is not None else None
    if not found:
        return None
    return _per_case(found, sum(s["end_ns"] - s["start_ns"] for s in found))


def idle_ms_per_case(run, name: str) -> Optional[float]:
    """Ms inside the spans named `name` in which no device activity of the
    trace ran, over the cases they name."""
    t = run.trace
    found = recorded(name) if t is not None and t.activities else None
    if not found:
        return None
    starts, ends = _union((a.start, a.start + a.dur) for a in t.activities)
    idle = 0
    for s in found:
        s0, s1 = s["start_ns"], s["end_ns"]
        busy = 0
        i = max(bisect.bisect_right(starts, s0) - 1, 0)
        while i < len(starts) and starts[i] < s1:
            busy += max(0, min(ends[i], s1) - max(starts[i], s0))
            i += 1
        idle += (s1 - s0) - busy
    return _per_case(found, idle)


def _union(intervals):
    """The union of (start, end) intervals as sorted, disjoint starts and
    ends."""
    starts, ends = [], []
    for s, e in sorted(intervals):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def device_ms_per_step(run, name: str) -> Optional[float]:
    """Device ms between the CUDA events of the spans named `name`, over
    the spans that have them (one a step)."""
    found = recorded(name) if run.trace is not None else None
    ms = [s["device_ms"] for s in found or () if s["device_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
