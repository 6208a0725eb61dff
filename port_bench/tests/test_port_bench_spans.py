"""The readers of the system's own spans (`port_bench/spans.py` and the
metrics that use it): their values on a synthetic run, None where nothing
was recorded or the system records no spans, and a traced tiny run on the
CPU that reports the host-clock ones."""

from __future__ import annotations

import pytest
import torch

from port_bench import run
from port_bench.registry import Registry
from port_bench.tests import tiny
from port_bench.trace import Activity, Trace
from waveformer_tpu_torch.utils import profiling

MS = 1_000_000  # ns
NEW = ("upload_ms_per_case", "upload_idle_ms_per_case", "dispatch_ms_per_case",
       "readback_ms_per_case", "forward_ms_per_step", "backward_ms_per_step",
       "optimizer_ms_per_step")


def _span(name, case, t0, t1, device_ms=None):
    return {"name": name, "case": case, "id": 0, "parent": None, "start_ns": t0 * MS,
            "end_ns": t1 * MS, "thread": 1, "device_ms": device_ms}


# two cases: uploads at 0-10 ms and 100-104 ms, the device busy 2-5 and 4-6
# (overlapping), 100-101 and 103-120
SPANS = [
    _span("predictor.upload", 0, 0, 10), _span("predictor.dispatch", 0, 10, 30),
    _span("predictor.upload", 1, 100, 104), _span("predictor.dispatch", 1, 104, 110),
    _span("predictor.readback", 0, 110, 150), _span("predictor.readback", 1, 150, 151),
    _span("train_step.forward", None, 200, 201, 240.0),
    _span("train_step.backward", None, 201, 202, 480.0),
    _span("train_step.optimizer", None, 202, 203, None),
    _span("train_step.forward", None, 300, 301, 260.0),
    _span("train_step.backward", None, 301, 302, 500.0),
]
ACTIVITIES = [Activity("k", a * MS, (b - a) * MS) for a, b in
              ((4, 6), (2, 5), (100, 101), (103, 120))]


def _run(activities=ACTIVITIES):
    trace = Trace(window_s=1.0, busy_s=0.5, activities=activities, gaps=[], attributed=True)
    return run.Run({}, {"completed": 2}, 1.0, 0, trace, None)


def _read(metric, r):
    return Registry(tiny.ROOT).reader(metric).read(r)


@pytest.mark.parametrize("metric,want", [
    ("upload_ms_per_case", (10 + 4) / 2),
    ("upload_idle_ms_per_case", ((10 - 4) + (4 - 2)) / 2),
    ("dispatch_ms_per_case", (20 + 6) / 2),
    ("readback_ms_per_case", (40 + 1) / 2),
    ("forward_ms_per_step", 250.0),
    ("backward_ms_per_step", 490.0),
])
def test_readers_on_a_synthetic_run(monkeypatch, metric, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert _read(metric, _run()) == pytest.approx(want)


@pytest.mark.parametrize("metric", NEW)
def test_nothing_recorded_reads_none(monkeypatch, metric):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(metric, _run()) is None
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert _read(metric, run.Run({}, {"completed": 2}, 1.0, 0, None, None)) is None


@pytest.mark.parametrize("metric", NEW)
def test_a_system_without_spans_reads_none(monkeypatch, metric):
    monkeypatch.delattr(profiling, "spans")
    assert _read(metric, _run()) is None


def test_no_device_events_or_activities_read_none(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert _read("optimizer_ms_per_step", _run()) is None
    assert _read("upload_idle_ms_per_case", _run(activities=[])) is None


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    profiling._RECORD.clear()  # the spans of an earlier traced run in this process
    yield tiny.make_root(str(tmp_path))
    profiling._RECORD.clear()


@pytest.mark.parametrize("cell,host,none", [
    ("tiny-case", ("upload_ms_per_case.case", "dispatch_ms_per_case.case",
                   "readback_ms_per_case.case"), ("upload_idle_ms_per_case.case",)),
    ("tiny-stream", ("upload_ms_per_case.serve",), ("upload_idle_ms_per_case.serve",)),
    ("tiny-train", (), ("forward_ms_per_step.train", "backward_ms_per_step.train",
                        "optimizer_ms_per_step.train")),
])
def test_a_traced_run_reports_the_host_spans(root, cell, host, none):
    """On the CPU the host spans read; the device ones (idle against device
    activities, CUDA events) are left out."""
    line = run.run_cell(cell, 5, 0.5, True, torch.device("cpu"), root=root)
    assert line["correct"] is True
    for m in host:
        assert line["metrics"][m]["value"] > 0 and line["metrics"][m]["unit"] == "ms"
    assert not set(none) & set(line["metrics"])
    names = {s["name"] for s in profiling.spans()}
    assert names == ({"train_step.forward", "train_step.backward", "train_step.optimizer"}
                     if cell == "tiny-train" else
                     {"predictor.upload", "predictor.dispatch", "predictor.readback"})
