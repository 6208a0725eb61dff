"""A checkout of the benchmark at a size a CPU test run holds: a copy of
`port_bench` and `BENCHMARK.json` in a temporary directory, with a tiny
configuration and three tiny cells (a stream, a one-case client and a
training step) added as files and entries, as a later change adds them;
with `add_toy`, a second architecture (`toy_arch.py`) and two cells of it;
with `add_ddp`, the tiny training step on two ranks."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

NETWORK = {
    "img_size": [32, 32, 32], "patch_size": 2, "in_chans": 2, "out_chans": 3,
    "embed_dims": [8, 16, 32, 64], "depths": [2, 2, 2, 2], "num_heads": [1, 2, 4, 8],
    "mlp_ratios": [4, 4, 4, 4], "decom_levels": [3, 2, 1, 0], "multi_scale_attention": True,
    "hf_refinement": False, "qkv_bias": True, "qk_scale": None, "drop_path_rate": 0.1,
    "norm_eps": 1e-6, "res_block": True,
}
CONFIG = {
    "network": NETWORK, "compute_dtype": "bfloat16",
    "serving": {"roi": [32, 32, 32], "sw_batch_size": 2, "overlap": 0.5, "blend": "gaussian",
                "case_shape": [2, 40, 36, 33]},
    "optimizer": {"lr": 1e-4, "weight_decay": 1e-2, "grad_clip_norm": 12.0},
}
TRAFFIC = {
    "tiny-stream": {"kind": "stream", "tta": 2, "ring": 2, "trace_units": 2,
                    "check_cases": 2, "check_batch": 2},
    "tiny-case": {"kind": "case", "tta": 1, "ring": 2, "trace_units": 2,
                  "check_cases": 2, "check_batch": 2},
    "tiny-train": {"kind": "train", "batch": 2, "ring": 3, "trace_units": 2},
}
# limits for the tiny cells: above what the system reads on the CPU in
# bf16, below what the float8 control and the faults read
LIMITS = {
    "tiny-stream": {"gap_max": 0.05},
    "tiny-case": {"gap_max": 0.05},
    "tiny-train": {"loss_gap": 6e-4, "grad_gap": 0.95, "change_gap": 0.15,
                   "last_loss_gap": 6e-4, "last_change_gap": 0.15},
}

# the training cells' metrics, which the tiny checkout adds as entries of
# its own where `BENCHMARK.json` has no training cell
TRAIN_METRICS = [
    {"name": "train_samples_per_s", "unit": "samples/s", "better": "higher", "bound": 0.01,
     "source": "host_clock"},
] + [
    {"name": name, "unit": unit, "better": better, "source": "device_trace", "layer": layer,
     "moves": "train_samples_per_s"}
    for name, unit, better, layer in (
        ("device_idle_pct.train", "%", "lower", "device"),
        ("mfu.train", "%", "higher", "training step"),
        ("forward_ms_per_step.train", "ms", "lower", "training step"),
        ("backward_ms_per_step.train", "ms", "lower", "training step"),
        ("optimizer_ms_per_step.train", "ms", "lower", "training step"))
]


def make_root(tmp: str) -> str:
    """A checkout at `tmp` holding the tiny cells; returns its root."""
    shutil.copytree(os.path.join(ROOT, "port_bench"), os.path.join(tmp, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pkg = os.path.join(tmp, "port_bench")
    with open(os.path.join(pkg, "configs", "tiny.json"), "w") as f:
        json.dump(CONFIG, f)
    bench["configs"].append({"name": "tiny", "source": "test", "file": "port_bench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for name, traffic in TRAFFIC.items():
        with open(os.path.join(pkg, "traffic", f"{name}.json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(pkg, "workloads", f"{name}.json"), "w") as f:
            json.dump({"limits": LIMITS[name]}, f)
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": name, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [n for n in TRAFFIC if _serves(n) == _serves_cells(m["workloads"])]
    have = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in TRAIN_METRICS:
        if m["name"] not in have:
            kind = "end_to_end" if "bound" in m else "per_layer"
            bench[kind].append({**m, "workloads": ["tiny-train"]})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def _serves(name: str) -> str:
    return {"tiny-stream": "stream", "tiny-case": "case", "tiny-train": "train"}[name]


def _serves_cells(cells) -> str:
    first = cells[0]
    return "train" if "train" in first else "case" if "case" in first else "stream"


TOY_CONFIG = {
    "arch": "toy",
    "network": {"img_size": [16, 16, 16], "in_chans": 2, "out_chans": 3, "width": 8},
    "compute_dtype": "bfloat16",
    "serving": {"roi": [16, 16, 16], "sw_batch_size": 2, "overlap": 0.5, "blend": "gaussian",
                "case_shape": [2, 20, 18, 17]},
    "optimizer": {"lr": 1e-3, "weight_decay": 1e-2, "grad_clip_norm": 12.0},
}
TOY_TRAFFIC = {
    "toy-stream": {"kind": "stream", "tta": 2, "ring": 2, "trace_units": 2,
                   "check_cases": 2, "check_batch": 2},
    "toy-train": {"kind": "train", "batch": 2, "ring": 3, "trace_units": 2},
}
# above what the toy system reads on the CPU in bf16, below what the
# float8 control reads on the first steps
TOY_LIMITS = {  # program (4 seeds) / control (4 seeds): gap_max 0.0017 / 0.0128+;
    # loss 4.6e-5 / 3.4e-4+, grad 0.0033 / 0.0126+, change 0.0018 / 0.0063+
    "toy-stream": {"gap_max": 0.006},
    "toy-train": {"loss_gap": 2e-4, "grad_gap": 0.007, "change_gap": 0.004,
                  "last_loss_gap": 2e-3, "last_change_gap": 0.02},
}
DDP_CELL = "tiny-train-ddp2"


def _add_cells(root: str, config: str, traffic: dict, limits: dict, chips: int = 1) -> None:
    """Add each cell of `traffic` on `config`: its traffic and limits files,
    its entry, and its name in the lists of the metrics that list a cell of
    its kind."""
    pkg = os.path.join(root, "port_bench")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for name, t in traffic.items():
        with open(os.path.join(pkg, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
        with open(os.path.join(pkg, "workloads", f"{name}.json"), "w") as f:
            json.dump({"limits": limits[name]}, f)
        bench["workloads"].append({"name": name, "config": config, "traffic": name,
                                   "chips": chips, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and _serves_cells(m["workloads"]) == t["kind"] \
                    and name not in m["workloads"]:
                m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f)


def add_toy(root: str) -> str:
    """Add the toy architecture, its configuration and its two cells to the
    checkout at `root`, as files and entries only."""
    pkg = os.path.join(root, "port_bench")
    shutil.copy(os.path.join(HERE, "toy_arch.py"), os.path.join(pkg, "archs", "toy.py"))
    with open(os.path.join(pkg, "configs", "toy.json"), "w") as f:
        json.dump(TOY_CONFIG, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy", "source": "test", "file": "port_bench/configs/toy.json",
                             "reduced": [], "why": "test"})
    with open(path, "w") as f:
        json.dump(bench, f)
    _add_cells(root, "toy", TOY_TRAFFIC, TOY_LIMITS)
    return root


def add_ddp(root: str) -> str:
    """Add the tiny training step on two ranks, its limits the one-rank
    cell's and `rank_gap` 0."""
    _add_cells(root, "tiny", {DDP_CELL: TRAFFIC["tiny-train"]},
               {DDP_CELL: {**LIMITS["tiny-train"], "rank_gap": 0.0}}, chips=2)
    return root
