"""Kind `case`: one client, one case at a time through the system's
`Predictor.predict_case`: host volume in, label map out, the next case
sent when the last one has come back, until the window's seconds are up.
Each case's latency is the host's time for that call.

Traffic keys: as `stream`'s.
"""

from __future__ import annotations

import time

from port_bench import serving


class Workload:
    def __init__(self, ctx):
        self.ctx = ctx
        self.served = serving.Served(ctx)
        self.cases = serving.make_cases(ctx)
        self.labels = {}
        self._run(units=1)  # warm-up: the cell's one case shape through the window's call
        self.labels = {}

    def _run(self, seconds=None, units=None):
        s = self.served
        latencies, failed = [], 0
        t0 = time.perf_counter()
        deadline = None if seconds is None else t0 + seconds
        i = 0
        while (units is None or i < units) and (deadline is None or time.perf_counter() < deadline):
            vol = self.cases[i % len(self.cases)]
            start = time.perf_counter()
            seg = s.predictor.predict_case(vol, s.span, s.out_channels)
            latencies.append(time.perf_counter() - start)
            failed += seg.shape != vol.shape[1:]
            self.labels[i] = seg
            i += 1
        return latencies, failed, time.perf_counter() - t0

    def window(self, seconds=None, units=None):
        span = self.served.span
        span.calls = span.rows = 0
        latencies, failed, elapsed = self._run(seconds, units)
        return {"attempted": len(latencies), "completed": len(latencies) - failed,
                "failed": failed, "elapsed_s": elapsed, "latencies_s": latencies,
                "forwards": span.calls, "patches": span.rows}

    def release(self):
        self.served.release()

    def check(self):
        return serving.check(self.ctx, self.cases, self.labels)

    def control(self):
        return serving.control(self.ctx, self.cases, self.labels)
