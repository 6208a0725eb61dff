"""The harness: `BENCHMARK.json` against the contract's shape, parts found
by name, the result line, the exits without a card or with JAX loaded, and
one cell on the card (marked `cuda`)."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import types

import pytest
import torch

from port_bench import run
from port_bench.registry import Registry
from port_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"device", "model forward", "training step", "stitch and case driver", "kernels",
          "gradient exchange"}


@pytest.fixture
def root(tmp_path):
    torch.set_num_threads(2)
    return tiny.make_root(str(tmp_path))


def test_benchmark_json_follows_the_contract():
    reg = Registry(tiny.ROOT)
    bench = reg.bench
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/configs/") and c["reduced"] == []
        assert os.path.exists(os.path.join(tiny.ROOT, c["file"]))
        assert 1 <= len(c["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    pairs = set()
    four = [w["name"] for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
        traffic = reg.traffic(w["traffic"])
        assert os.path.exists(os.path.join(reg.pkg, "kinds", f"{traffic['kind']}.py"))
        limits = reg.limits(w["name"])
        assert limits and all(isinstance(v, float) for v in limits.values()), w["name"]
        reported = reg.metrics(w["name"], False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert reg.metrics(w["name"], True)
    assert len(pairs) == len(bench["workloads"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(reg.pkg, "metrics", m["name"].split(".")[0] + ".py"))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["layer"] in LAYERS and m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in reg.metrics(cell, False)}
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_cell_config_and_metric_added_as_files_are_found_by_name(root):
    with open(os.path.join(root, "port_bench", "metrics", "cases_done.py"), "w") as f:
        f.write("def read(run):\n    return float(run.window['completed'])\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["end_to_end"].append({"name": "cases_done", "unit": "cases", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-case"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    line = run.run_cell("tiny-case", 3, 0.5, False, torch.device("cpu"), root=root)
    assert set(line["metrics"]) == {"case_latency_p90_s", "setup_s", "cases_done"}
    assert line["metrics"]["cases_done"]["value"] == line["attempted"] - line["failed"]


def test_result_line(root):
    line = run.run_cell("tiny-stream", 2, 0.5, False, torch.device("cpu"), root=root)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checked"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"cases_per_s", "setup_s"}
    assert line["checked"]["gap_max"]["limit"] == tiny.LIMITS["tiny-stream"]["gap_max"]


def test_traced_run_reports_per_layer_metrics_it_can_read(root):
    line = run.run_cell("tiny-train", 77, 0.5, True, torch.device("cpu"), root=root)
    assert line["correct"] is True
    assert "window_s" in line["device"] and "breakdown" in line
    # no device on the CPU: the device metrics read nothing and are left out
    assert "mfu.train" not in line["metrics"]


def test_no_cuda_device_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "brats-case-tta1", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_loaded_jax_module_fails_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"checked": {}})
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "waveformer_tpu_torch_extra", types.ModuleType("x"))
    assert run.banned_modules() == []
    for name in ("jaxlib.xla_client", "waveformer_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    rc = run.main(["--workload", "brats-case-tta1", "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc == 3 and captured.out == ""
    assert "jaxlib" in captured.err and "waveformer_tpu" in captured.err


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "brats-case-tta1",
         "--seed", "12", "--seconds", "3", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
