"""A checkout of the benchmark at a size a CPU test run holds: a copy of
`port_bench` and `BENCHMARK.json` in a temporary directory, with a tiny
configuration and three tiny cells (a stream, a one-case client and a
training step) added as files and entries, as a later change adds them."""

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
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def _serves(name: str) -> str:
    return {"tiny-stream": "stream", "tiny-case": "case", "tiny-train": "train"}[name]


def _serves_cells(cells) -> str:
    first = cells[0]
    return "train" if "train" in first else "case" if "case" in first else "stream"
