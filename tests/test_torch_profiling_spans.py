"""The port's spans (`utils.profiling.span`): recorded only while a
`torch.profiler` runs, on the profiler's clock, with the enclosing span as
parent; the case driver's upload, dispatch and read-back of each case, and
the training step's forward, backward and optimizer phases.

The file imports no JAX. The tests marked `cuda` (device events, the case
driver on the card) skip without a CUDA device:

    python -m pytest tests/test_torch_profiling_spans.py --noconftest -q
"""

import json
import threading

import numpy as np
import pytest
import torch

from waveformer_tpu_torch.inference.predictor import Predictor
from waveformer_tpu_torch.inference.sliding_window import SlidingWindowInferer
from waveformer_tpu_torch.training.state import TrainState, make_optimizer, make_train_step
from waveformer_tpu_torch.utils import profiling

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]
CASE_SPANS = ("predictor.upload", "predictor.dispatch", "predictor.readback")
STEP_SPANS = ("train_step.forward", "train_step.backward", "train_step.optimizer")


@pytest.fixture(autouse=True)
def _empty_record():
    profiling._RECORD.clear()
    yield
    profiling._RECORD.clear()


def _profiled(fn, activities=CPU_ONLY):
    """Run `fn` under a profiler; (its spans, the profiler's kineto events)."""
    profiling._RECORD.clear()
    with torch.profiler.profile(activities=activities) as prof:
        fn()
    return profiling.spans(), list(prof.profiler.kineto_results.events())


def toy(p):
    """A patch callable of the inferer: (B, 2, ...) → (B, 3, ...) logits."""
    mix = torch.tensor([[1.0, -0.5], [0.3, 0.8], [-0.7, 0.2]], device=p.device)
    return torch.einsum("bcdhw,oc->bodhw", torch.tanh(p.float()), mix)


def _predictor(device="cpu"):
    inferer = SlidingWindowInferer((16, 16, 16), sw_batch_size=2, overlap=0.5,
                                   mirror_axes=(0,), tta_mode="patch", layout="channels_first")
    return Predictor(inferer, device=device)


def _volumes(n):
    rng = np.random.default_rng(3)
    return [rng.standard_normal((2, 20, 24, 18)).astype(np.float32) for _ in range(n)]


class Toy(torch.nn.Module):
    """A module with the step's calling convention."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(2, 3, 3, padding=1)

    def forward(self, x, generator=None):
        return self.conv(x)


def _toy_step(device="cpu"):
    torch.manual_seed(0)
    model = Toy().to(device)
    state = TrainState.create({n: p for n, p in model.named_parameters()}, make_optimizer())
    step = make_train_step(model, lambda logits, seg: torch.nn.functional.cross_entropy(
        logits, seg[:, 0].long()))
    g = torch.Generator().manual_seed(1)
    batch = {"data": torch.randn(2, 2, 6, 6, 6, generator=g).to(device),
             "seg": torch.randint(0, 3, (2, 1, 6, 6, 6), generator=g).to(device)}
    return state, step, batch


def test_off_a_span_is_one_shared_null_context_and_records_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b", case=3, device=True)
    with profiling.span("a", case=1):
        with profiling.span("b", device=True):
            pass
    assert entered == [] and profiling.spans() == []


def test_spans_lie_on_the_profilers_clock():
    def work():
        with profiling.span("outer", case=7):
            torch.randn(64, 64) @ torch.randn(64, 64)
            with profiling.span("inner", case=7):
                torch.randn(32, 32).sum()

    spans, events = _profiled(work)
    assert [s["name"] for s in spans] == ["inner", "outer"]
    for s in spans:
        match = [e for e in events if e.name() == s["name"]]
        assert len(match) == 1
        assert abs(match[0].start_ns() - s["start_ns"]) < 1_000_000
        assert abs(match[0].end_ns() - s["end_ns"]) < 1_000_000
        assert s["start_ns"] <= s["end_ns"] and s["case"] == 7
        assert s["device_ms"] is None  # no device events asked for


def test_parent_is_the_enclosing_span():
    def work():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("e"):
                pass

    spans, _ = _profiled(work)
    by = {s["name"]: s for s in spans}
    assert by["a"]["parent"] is None
    assert by["b"]["parent"] == by["a"]["id"] and by["e"]["parent"] == by["a"]["id"]
    assert by["c"]["parent"] == by["b"]["id"]
    assert len({s["id"] for s in spans}) == 4
    assert {s["thread"] for s in spans} == {threading.get_ident()}


def test_a_thread_the_profiler_does_not_trace_records_nothing():
    """`torch.profiler` traces the thread that started it; a span on
    another thread is off, as its `record_function` would record nothing."""
    seen = []

    def other():
        seen.append(torch.autograd._profiler_enabled())
        with profiling.span("other"):
            pass

    def work():
        with profiling.span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()

    spans, _ = _profiled(work)
    assert seen == [False] and [s["name"] for s in spans] == ["main"]


def test_trace_writes_the_spans_and_starts_a_fresh_record(tmp_path):
    with torch.profiler.profile(activities=CPU_ONLY):
        with profiling.span("before"):
            pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("inside", case=2):
            torch.randn(8, 8).sum()
    assert [(s["name"], s["case"]) for s in profiling.spans()] == [("inside", 2)]
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "inside" in names and "before" not in names


def test_the_record_is_bounded():
    def work():
        for i in range(profiling._RECORD.maxlen + 5):
            with profiling.span("s", case=i):
                pass

    spans, _ = _profiled(work)
    assert len(spans) == profiling._RECORD.maxlen and spans[0]["case"] == 5


def _check_cases(spans, n):
    """Each case has its upload, dispatch and read-back, in that order, under
    one id; `n` ids in all. Returns the spans' (name, case) in order."""
    assert {s["name"] for s in spans} == set(CASE_SPANS)
    cases = sorted({s["case"] for s in spans})
    assert len(cases) == n
    for c in cases:
        mine = [s for s in spans if s["case"] == c]
        assert [s["name"] for s in sorted(mine, key=lambda s: s["start_ns"])] == list(CASE_SPANS)
        assert all(s["parent"] is None for s in mine)
    return [(s["name"], cases.index(s["case"])) for s in sorted(spans, key=lambda s: s["start_ns"])]


def test_predict_case_records_upload_dispatch_and_readback_of_each_case():
    pred, vols = _predictor(), _volumes(2)
    segs = []
    spans, _ = _profiled(lambda: segs.extend(pred.predict_case(v, toy, 3) for v in vols))
    _check_cases(spans, 2)
    assert [s.shape for s in segs] == [(20, 24, 18)] * 2


def test_predict_cases_reads_case_i_back_after_case_i_plus_1_is_dispatched():
    pred, vols = _predictor(), _volumes(3)
    segs = []
    spans, _ = _profiled(lambda: segs.extend(pred.predict_cases(vols, toy, 3)))
    order = _check_cases(spans, 3)
    assert order == [("predictor.upload", 0), ("predictor.dispatch", 0),
                     ("predictor.upload", 1), ("predictor.dispatch", 1), ("predictor.readback", 0),
                     ("predictor.upload", 2), ("predictor.dispatch", 2), ("predictor.readback", 1),
                     ("predictor.readback", 2)]
    # the spans change nothing in what is served
    for v, seg in zip(vols, segs):
        np.testing.assert_array_equal(seg, _predictor().predict_case(v, toy, 3))


def test_a_volume_already_on_the_device_has_no_upload_span():
    pred = _predictor()
    spans, _ = _profiled(lambda: pred.predict_case(torch.from_numpy(_volumes(1)[0]), toy, 3))
    assert [s["name"] for s in spans] == ["predictor.dispatch", "predictor.readback"]


def test_a_train_step_records_forward_backward_and_optimizer_in_order():
    state, step, batch = _toy_step()
    spans, events = _profiled(lambda: [step(state, batch) for _ in range(2)])
    assert [s["name"] for s in spans] == list(STEP_SPANS) * 2
    for a, b in zip(spans, spans[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert all(s["parent"] is None for s in spans)
    names = [e.name() for e in events]
    assert all(names.count(n) == 2 for n in STEP_SPANS)
    assert state.step == 2


def test_spans_leave_the_train_step_unchanged():
    results = []
    for profiled in (False, True):
        state, step, batch = _toy_step()
        run = lambda: [step(state, batch) for _ in range(3)]  # noqa: E731
        _profiled(run) if profiled else run()
        results.append({n: p.clone() for n, p in state.params.items()})
    for n in results[0]:
        torch.testing.assert_close(results[0][n], results[1][n], rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for device events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_spans_give_device_ms_on_the_card(cuda_device):
    x = torch.randn(2048, 2048, device=cuda_device)

    def work():
        with profiling.span("mm", device=True):
            for _ in range(20):
                x @ x

    spans, _ = _profiled(work, CPU_ONLY + [torch.profiler.ProfilerActivity.CUDA])
    (s,) = spans
    assert s["device_ms"] > 0.1


@pytest.mark.cuda
def test_the_train_step_and_the_case_driver_on_the_card(cuda_device):
    state, step, batch = _toy_step(cuda_device)
    acts = CPU_ONLY + [torch.profiler.ProfilerActivity.CUDA]
    spans, _ = _profiled(lambda: step(state, batch), acts)
    assert [s["name"] for s in spans] == list(STEP_SPANS)
    assert all(s["device_ms"] > 0 for s in spans)
    pred = _predictor(cuda_device)
    spans, _ = _profiled(lambda: list(pred.predict_cases(_volumes(2), toy, 3)), acts)
    _check_cases(spans, 2)
