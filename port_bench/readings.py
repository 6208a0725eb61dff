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
One JSON line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import weights
from port_bench.registry import Registry
from port_bench.run import ROOT, Context, host_threads


def reading(reg, cell, seed, seconds, what, device):
    t0 = time.perf_counter()
    entry = reg.cell(cell)
    config, traffic = reg.config(entry["config"]), reg.traffic(entry["traffic"])
    ctx = Context(device, seed, config, traffic)
    ctx.state_dict = weights.make_state_dict(config["network"], seed, device)
    host_threads(traffic)
    kind = reg.kind(traffic["kind"])
    kw = {"loss_fault": kind.half_batch_loss} if what == "fault" else {}
    workload = kind.Workload(ctx, **kw)
    window = workload.window(seconds=seconds)
    workload.release()
    numbers = workload.control() if what == "control" else workload.check()
    return {"cell": cell, "seed": seed, "reading": what, **numbers,
            "completed": window["completed"], "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    from waveformer_tpu_torch.ops import _build

    _build.LIBRARIES.build_all()
    reg = Registry(ROOT)
    device = torch.device("cuda", 0)
    for what, seeds in (("program", args.seeds), ("control", args.control_seeds),
                        ("fault", args.fault_seeds)):
        for seed in seeds:
            print(json.dumps(reading(reg, args.workload, seed, args.seconds, what, device)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
