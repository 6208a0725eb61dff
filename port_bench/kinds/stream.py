"""Kind `stream`: one client sends cases back to back through the
system's pipelined `Predictor.predict_cases` (case i + 1's upload and
launches are queued before case i's label map is read back). Closed loop:
the next case goes in when the pipeline asks for it, until the window's
seconds are up; the case in flight then finishes.

Traffic keys: `tta` (mirror orientations), `ring` (distinct volumes, sent
in turn), `trace_units` (cases in a traced window), `check_cases` and
`check_batch` (the check's sample and the reference's patch batch),
optionally `host_threads` (the client's host threads).
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
        # warm-up: the cell's one case shape through the window's own call
        self._stream(units=1)
        self.labels = {}

    def _stream(self, seconds=None, units=None):
        s = self.served
        submitted, done = [], []
        failed = 0
        deadline = None if seconds is None else time.perf_counter() + seconds

        def feed():
            i = 0
            while (units is None or i < units) and (deadline is None or time.perf_counter() < deadline):
                submitted.append(time.perf_counter())
                yield self.cases[i % len(self.cases)]
                i += 1

        for i, seg in enumerate(s.predictor.predict_cases(feed(), s.span, s.out_channels)):
            done.append(time.perf_counter())
            if seg.shape != self.cases[i % len(self.cases)].shape[1:]:
                failed += 1
            self.labels[i] = seg
        return submitted, done, failed

    def window(self, seconds=None, units=None):
        span = self.served.span
        span.calls = span.rows = 0
        submitted, done, failed = self._stream(seconds, units)
        return {"attempted": len(submitted), "completed": len(done) - failed,
                "failed": len(submitted) - len(done) + failed,
                "elapsed_s": done[-1] - submitted[0], "forwards": span.calls,
                "patches": span.rows}

    def release(self):
        self.served.release()

    def check(self):
        return serving.check(self.ctx, self.cases, self.labels)

    def control(self):
        return serving.control(self.ctx, self.cases, self.labels)
