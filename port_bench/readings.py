"""Readings that set a cell's limits: the numbers its check compares, for
the system on many seeds, for the lower-precision control and for planted
faults, in one process. The benchmark's own runs do not run this.

    python3 -m port_bench.readings --workload CELL --seconds S \\
        --seeds N [N ...] [--control-seeds N ...] [--fault-seeds N ...]

Each seed sets up the cell as a run does, runs its traffic for S seconds
(a short window at the cell's own load), frees the system and reads:
  program:  the check's numbers for the system;
  control:  the same numbers for the reference in float8 in the system's
            place, judged by the float32 reference;
  fault:    (training cells) the system with the loss of half of each
            batch only.
One JSON line per reading on standard output. A cell on more than one card
runs every reading on all its cards, one process a card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench.ranks import Ranks, launch
from port_bench.registry import Registry
from port_bench.run import ROOT, Context, build_kernels, host_threads


def reading(reg, cell, seed, seconds, what, device, ranks=None):
    t0 = time.perf_counter()
    entry = reg.cell(cell)
    config, traffic = reg.config(entry["config"]), reg.traffic(entry["traffic"])
    arch = reg.arch(config)
    ctx = Context(device, seed, config, traffic, arch, ranks=ranks or Ranks())
    ctx.state_dict = arch.make_state_dict(config["network"], seed, device)
    host_threads(traffic)
    kind = reg.kind(traffic["kind"])
    kw = {"loss_fault": kind.half_batch_loss} if what == "fault" else {}
    workload = kind.Workload(ctx, **kw)
    window = workload.window(seconds=seconds)
    workload.release()
    numbers = workload.control() if what == "control" else workload.check()
    return {"cell": cell, "seed": seed, "reading": what, **numbers,
            "completed": window["completed"], "seconds": time.perf_counter() - t0}


def read_all(ranks, device, cell, seconds, plan):
    """Every reading of `plan` ((what, seeds), ...) on this rank; rank 0
    prints each."""
    reg = Registry(ROOT)
    build_kernels(device)
    for what, seeds in plan:
        for seed in seeds:
            line = reading(reg, cell, seed, seconds, what, device, ranks)
            if ranks.rank == 0:
                print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    chips = Registry(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"readings: the cell needs {chips} CUDA device(s)", file=sys.stderr)
        return 2
    plan = (("program", args.seeds), ("control", args.control_seeds),
            ("fault", args.fault_seeds))
    if chips == 1:
        read_all(Ranks(), torch.device("cuda", 0), args.workload, args.seconds, plan)
    else:
        build_kernels(torch.device("cuda"))
        launch(chips, "cuda", read_all, (args.workload, args.seconds, plan), deadline_s=3300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
