"""Architectures as modules (`port_bench/archs/`): a toy second architecture
runs through `run_cell` as files and entries only, a configuration without
`arch` builds WaveFormer, an unknown one exits before any weights, and the
WaveFormer module reads what the harness read before it was moved there."""

from __future__ import annotations

import ast
import glob
import hashlib
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, run
from port_bench.registry import Registry
from port_bench.tests import tiny
from port_bench.trace import Trace

CPU = torch.device("cpu")

# what the harness read at the tiny size before the architectures became
# modules (commit c942ea1): `weights.make_state_dict(tiny.NETWORK, 5, "cpu")`
# hashed by `_digest`, and `flops.model_counts(tiny.NETWORK, 2)`
PARENT_DIGEST = "a5edcb44c9a752b60ce24f1f98a5617886f4e818e9de98291f61a5e6e86fea26"
PARENT_KEYS = 232
PARENT_FLOPS = 1454874624
PARENT_CALLS = [
    ("window_attention", (128, 1, 8, 8)), ("window_attention", (16, 1, 8, 8)),
    ("window_attention", (2, 1, 8, 8)), ("dwconv3", (2, 16, 16, 16, 32)),
    ("window_attention", (128, 1, 8, 8)), ("window_attention", (16, 1, 8, 8)),
    ("window_attention", (2, 1, 8, 8)), ("dwconv3", (2, 16, 16, 16, 32)),
    ("window_attention", (16, 2, 8, 8)), ("window_attention", (2, 2, 8, 8)),
    ("dwconv3", (2, 8, 8, 8, 64)), ("window_attention", (16, 2, 8, 8)),
    ("window_attention", (2, 2, 8, 8)), ("dwconv3", (2, 8, 8, 8, 64)),
    ("window_attention", (2, 4, 8, 8)), ("dwconv3", (2, 4, 4, 4, 128)),
    ("window_attention", (2, 4, 8, 8)), ("dwconv3", (2, 4, 4, 4, 128)),
    ("window_attention", (2, 8, 8, 8)), ("dwconv3", (2, 2, 2, 2, 256)),
    ("window_attention", (2, 8, 8, 8)), ("dwconv3", (2, 2, 2, 2, 256)),
    ("dwconv3", (2, 16, 16, 16, 32)), ("dwconv3", (2, 16, 16, 16, 16)),
]


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return tiny.add_toy(tiny.make_root(str(tmp_path)))


def _digest(sd) -> str:
    h = hashlib.sha256()
    for n, t in sd.items():
        h.update(n.encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _workload(root, cell, seed):
    reg = Registry(root)
    entry = reg.cell(cell)
    config = reg.config(entry["config"])
    ctx = run.Context(CPU, seed, config, reg.traffic(entry["traffic"]), reg.arch(config))
    ctx.state_dict = ctx.arch.make_state_dict(config["network"], seed, CPU)
    return reg.kind(ctx.traffic["kind"]).Workload(ctx)


def test_waveformer_reads_what_it_read_before_the_move():
    arch = Registry(tiny.ROOT).arch({"network": tiny.NETWORK})
    sd = arch.make_state_dict(tiny.NETWORK, 5, "cpu")
    assert len(sd) == PARENT_KEYS and _digest(sd) == PARENT_DIGEST
    counts = flops.model_counts(arch, tiny.NETWORK, 2)
    assert counts["forward_flops"] == PARENT_FLOPS
    assert counts["calls"] == PARENT_CALLS


def test_a_configuration_without_arch_is_waveformer():
    reg = Registry(tiny.ROOT)
    for c in reg.bench["configs"]:
        config = reg.config(c["name"])
        assert "arch" not in config
        assert reg.arch(config).__name__ == "port_bench.archs.waveformer"


@pytest.mark.parametrize("cell", ["toy-stream", "toy-train"])
def test_a_second_architecture_runs_correct(root, cell):
    line = run.run_cell(cell, 3, 0.5, False, CPU, root=root)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checked"]) == set(tiny.TOY_LIMITS[cell])


def test_a_second_architecture_has_its_own_weights(root):
    w = _workload(root, "toy-train", 4)
    sd = w.ctx.state_dict
    assert set(sd) == {f"{m}.{p}" for m in ("enc", "norm", "down", "dec", "out")
                       for p in ("weight", "bias")}
    assert set(w.model.state_dict()) == set(sd)
    assert sd["enc.weight"].shape == (8, 2, 3, 3, 3)


@pytest.mark.parametrize("cell,seed", [("toy-stream", 5), ("toy-train", 6)])
def test_the_float8_control_of_a_second_architecture_fails(root, cell, seed):
    w = _workload(root, cell, seed)
    w.window(seconds=0.3)
    w.release()
    numbers = w.control()
    assert any(numbers[k] > v for k, v in tiny.TOY_LIMITS[cell].items())


def test_a_second_architecture_has_its_own_mfu(root):
    reg = Registry(root)
    config = reg.config("toy")
    arch = reg.arch(config)
    net = config["network"]
    model = arch.build(net, "cpu")
    model.load_state_dict(arch.make_state_dict(net, 1, "cpu"))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.randn(2, *net["img_size"], net["in_chans"]))
    counts = flops.model_counts(arch, net, 2)
    assert counts["forward_flops"] == counter.get_total_flops() > 0
    assert counts["calls"] == []
    trace = Trace(window_s=2.0, busy_s=1.0, activities=[], gaps=[], attributed=True)
    r = run.Run(config, {"samples": 10, "completed": 5}, 1.0, 0, trace,
                {"bf16_flops": 1e12, "hbm_bytes": 1e12}, arch)
    want = 100.0 * 3 * flops.model_counts(arch, net, 1)["forward_flops"] * 10 / 2.0 / 1e12
    assert reg.reader("mfu.train").read(r) == pytest.approx(want)
    assert reg.reader("window_attention_roofline").read(r) is None


def test_an_unknown_arch_exits_1_before_any_weights(root, monkeypatch, capsys):
    path = os.path.join(root, "port_bench", "configs", "toy.json")
    with open(path) as f:
        config = json.load(f)
    config["arch"] = "swin_unetr_unknown"
    with open(path, "w") as f:
        json.dump(config, f)
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_run(*a, **k):
        raise AssertionError("the cell ran")

    monkeypatch.setattr(run, "run_chips", no_run)
    rc = run.main(["--workload", "toy-train", "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc == 1 and captured.out == ""
    assert "swin_unetr_unknown" in captured.err
    with pytest.raises(KeyError, match="swin_unetr_unknown"):
        run.run_cell("toy-train", 1, 0.5, False, CPU, root=root)


def test_only_the_architecture_modules_import_a_model():
    """No harness module outside `port_bench/archs/` (and the references
    themselves) imports the system's models or the reference model."""
    pkg = os.path.join(tiny.ROOT, "port_bench")
    files = [f for pattern in ("*.py", "kinds/*.py", "metrics/*.py")
             for f in glob.glob(os.path.join(pkg, pattern))]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                assert not name.startswith(("waveformer_tpu_torch.models",
                                            "port_bench.reference.model")), (path, name)
