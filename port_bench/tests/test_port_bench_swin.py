"""The `swin_unetr` architecture module at a CPU test's size, in a tiny
checkout of its own: its state dict loads into the system and the plain
reference, the two agree, its calls are the masked attention's, its cell
runs correct and its float8 control fails, a program without the model
exits before any weights, and the readers of the model's spans read the
spans' device time a case, or nothing where none was recorded."""

from __future__ import annotations

import importlib.util
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, run
from port_bench.registry import Registry
from port_bench.tests import tiny
from port_bench.trace import Trace
from waveformer_tpu_torch.utils import profiling

CPU = torch.device("cpu")

# SwinUNETR-V2 at a CPU test's size: 32^3 patches pad stages 1-2 to whole
# 7^3 windows and shift them; stages 3-4 take 4^3 and 2^3 windows unshifted
SWIN = {"img_size": [32, 32, 32], "in_channels": 2, "out_channels": 3,
        "feature_size": 12, "depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24],
        "window_size": 7, "patch_size": 2, "drop_path_rate": 0.0, "use_v2": True}
CONFIG = {
    "arch": "swin_unetr", "network": SWIN, "compute_dtype": "bfloat16",
    "serving": {"roi": [32, 32, 32], "sw_batch_size": 2, "overlap": 0.5, "blend": "gaussian",
                "case_shape": [2, 40, 36, 33]},
}
CELL = "swin-stream"
LIMITS = {CELL: {"gap_max": 0.05}}
# (B·nW, H, N, D) of each attention call of a batch-2 forward at 32^3: stage 1
# pads 16^3 to 21^3 (27 windows), stage 2 8^3 to 14^3 (8), both shifted on
# their second block; stages 3-4 take 4^3 and 2^3 windows, one a sample
CALLS = [("window_attention", s) for s in
         [(54, 3, 343, 4)] * 2 + [(16, 6, 343, 4)] * 2 + [(2, 12, 64, 4)] * 2
         + [(2, 24, 8, 4)] * 2]
READERS = ("swin_encoder_ms_per_case", "window_shuffle_ms_per_case")


def add_swin(root: str) -> str:
    """Add the tiny SwinUNETR-V2 configuration and its stream cell to the
    checkout at `root`, as files and entries only."""
    with open(os.path.join(root, "port_bench", "configs", "swin.json"), "w") as f:
        json.dump(CONFIG, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "swin", "source": "test", "file": "port_bench/configs/swin.json",
                             "reduced": [], "why": "test"})
    with open(path, "w") as f:
        json.dump(bench, f)
    tiny._add_cells(root, "swin", {CELL: tiny.TRAFFIC["tiny-stream"]}, LIMITS)
    return root


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(4)
    return add_swin(tiny.make_root(str(tmp_path)))


def _arch():
    return Registry(tiny.ROOT).arch({"arch": "swin_unetr", "network": SWIN})


def test_each_configuration_names_a_module_that_loads():
    reg = Registry(tiny.ROOT)
    for c in reg.bench["configs"]:
        config = reg.config(c["name"])
        want = config.get("arch", "waveformer")
        assert reg.arch(config).__name__ == f"port_bench.archs.{want}"
    assert reg.config("swinunetr-v2-brats")["arch"] == "swin_unetr"


def test_swin_unetr_meets_the_contract():
    torch.set_num_threads(4)
    arch = _arch()
    assert arch.io(SWIN) == (2, 3, (32, 32, 32))
    sd = arch.make_state_dict(SWIN, 11, "cpu")
    system = arch.system(SWIN, torch.float32, "cpu")
    reference = arch.build(SWIN, "cpu")
    assert list(sd) == list(reference.state_dict()) == list(system.state_dict())
    system.load_state_dict(sd, strict=True)
    reference.load_state_dict(sd, strict=True)
    x = torch.randn(2, 32, 32, 32, 2, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = reference(x)
        got = system(x)
    # fp32 on both sides, sums in another order: 1e-4 of the logits' range
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    counts = flops.model_counts(arch, SWIN, 2)
    assert counts["calls"] == CALLS
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        reference(x)
    assert counts["forward_flops"] == counter.get_total_flops() > 0


def _workload(root, cell, seed):
    reg = Registry(root)
    entry = reg.cell(cell)
    config = reg.config(entry["config"])
    ctx = run.Context(CPU, seed, config, reg.traffic(entry["traffic"]), reg.arch(config))
    ctx.state_dict = ctx.arch.make_state_dict(config["network"], seed, CPU)
    return reg.kind(ctx.traffic["kind"]).Workload(ctx)


def test_swin_unetr_cell_runs_correct_and_its_control_fails(root):
    line = run.run_cell(CELL, 4, 0.3, False, CPU, root=root)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    w = _workload(root, CELL, 6)
    w.window(seconds=0.3)
    w.release()
    assert w.control()["gap_max"] > LIMITS[CELL]["gap_max"]


def test_swin_unetr_on_a_program_without_it_exits_1_before_any_weights(
        root, monkeypatch, capsys):
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "waveformer_tpu_torch.models.swin_unetr" else find(name, *a))
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_run(*a, **k):
        raise AssertionError("the cell ran")

    monkeypatch.setattr(run, "run_chips", no_run)
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc == 1 and captured.out == ""
    assert "swin_unetr" in captured.err


MS = 1_000_000  # ns


def _span(name, t0, t1, device_ms):
    return {"name": name, "case": None, "id": 0, "parent": None, "start_ns": t0 * MS,
            "end_ns": t1 * MS, "thread": 1, "device_ms": device_ms}


SPANS = [
    _span("swin.encoder", 400, 401, 30.0), _span("swin.encoder", 402, 403, 34.0),
    _span("swin.window_shuffle", 400, 401, 1.5), _span("swin.window_shuffle", 401, 402, 2.5),
    _span("swin.window_shuffle", 402, 403, None),
]


def _run(trace=True):
    trace = Trace(window_s=1.0, busy_s=0.5, activities=[], gaps=[], attributed=True) \
        if trace else None
    return run.Run({}, {"completed": 2}, 1.0, 0, trace, None)


def _read(metric, r):
    return Registry(tiny.ROOT).reader(metric).read(r)


@pytest.mark.parametrize("metric,want", [
    ("swin_encoder_ms_per_case", (30.0 + 34.0) / 2),
    ("window_shuffle_ms_per_case", (1.5 + 2.5) / 2),
])
def test_swin_readers_on_a_synthetic_run(monkeypatch, metric, want):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert _read(metric, _run()) == pytest.approx(want)


@pytest.mark.parametrize("metric", READERS)
def test_swin_readers_read_none_without_spans(monkeypatch, metric):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert _read(metric, _run()) is None
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert _read(metric, _run(trace=False)) is None
    monkeypatch.delattr(profiling, "spans")
    assert _read(metric, _run()) is None
