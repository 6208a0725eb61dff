"""Run one cell of the benchmark of `waveformer_tpu_torch` once, on the
machine it starts on.

    python3 -m port_bench.run --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout. In order: check for the cards the cell asks
for and find its configuration's architecture (`port_bench/archs/`), build
the system's kernels (cached inside the checkout), make the weights on the
card from the seed and load them into the system under the reference keys,
set up the cell's traffic kind (its inputs, the warm-up of the cell's own
shapes), then run the closed-loop traffic for S seconds (with `--trace 1`:
the traffic's traced window under `torch.profiler`), read the peak memory,
free the system's state, check what the timed path produced against the
plain reference, and print one JSON line: with `--trace 0` the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics. The numbers the
check compared, each beside its limit, are the last lines on standard
error and the last key of the line.

A cell on more than one card runs one process per card (`port_bench.ranks`),
each through all of the above on its own card after one barrier, paced by
rank 0; `--trace 1` traces rank 0. Rank 0 puts the line together:
`device.count` the cards, the largest rank's peak memory, `attempted` and
`failed` summed over the ranks; this process prints it once every rank has
ended.

Exit codes: 0 with a result line; 2 without the cards the cell asks for;
3 when a module of JAX or of the JAX package was loaded (in any rank); 1 on
any error, an unknown architecture or a rank that failed or hung.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from types import ModuleType  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches the run's libraries write go inside the checkout, at fixed paths
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                      os.path.join(ROOT, "port_bench", "_cache", "torch_kernels"))

import torch  # noqa: E402

from port_bench.ranks import Ranks, RankFailed, launch  # noqa: E402
from port_bench.registry import Registry, UnknownArch  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "optax", "waveformer_tpu")


@dataclass
class Context:
    """What a traffic kind is given: the device, the seed, the cell's
    configuration and traffic files, the configuration's architecture
    module, the weights, and the other ranks of a multi-card cell."""

    device: torch.device
    seed: int
    config: Dict
    traffic: Dict
    arch: Optional[ModuleType] = None
    state_dict: Dict = field(default_factory=dict)
    ranks: Ranks = field(default_factory=Ranks)


@dataclass
class Run:
    """What the metric readers read."""

    config: Dict
    window: Dict
    setup_s: float
    peak_bytes: int
    trace: Optional[object]
    peak: Optional[Dict]
    arch: Optional[ModuleType] = None
    chips: int = 1


def banned_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def host_threads(traffic: Dict) -> None:
    """The client's host threads, where the traffic fixes them."""
    if "host_threads" in traffic:
        torch.set_num_threads(int(traffic["host_threads"]))


def device_memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def build_kernels(device: torch.device) -> None:
    if device.type == "cuda":
        from waveformer_tpu_torch.ops import _build

        _build.LIBRARIES.build_all()


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: torch.device,
             root: str = ROOT, start: float = PROCESS_START,
             ranks: Optional[Ranks] = None) -> Optional[Dict]:
    """One run of `cell`; returns the result line's object. `device` is
    the card, or the CPU in the benchmark's own tests. With `ranks`, this
    is one rank of a multi-card run: rank 0 returns the line, the others
    report to it and return None."""
    from port_bench import peaks

    ranks = ranks or Ranks()
    reg = Registry(root)
    entry = reg.cell(cell)
    config, traffic = reg.config(entry["config"]), reg.traffic(entry["traffic"])
    arch = reg.arch(config)
    limits = reg.limits(cell)
    host_threads(traffic)
    build_kernels(device)
    ctx = Context(device, seed, config, traffic, arch, ranks=ranks)
    ctx.state_dict = arch.make_state_dict(config["network"], seed, device)
    workload = reg.kind(traffic["kind"]).Workload(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ranks.barrier("window")
    setup_s = time.perf_counter() - start

    summary = None
    if trace and ranks.rank == 0:
        from port_bench.trace import profiled

        with profiled() as traced:
            window = workload.window(units=int(traffic["trace_units"]))
        summary = traced["trace"]
        print(f"port_bench: traced window {summary.window_s:.3f} s, busy {summary.busy_s:.3f} s, "
              f"{summary.extra}, attributed {summary.attributed}", file=sys.stderr)
    elif trace:
        window = workload.window(units=int(traffic["trace_units"]))
    else:
        window = workload.window(seconds=seconds)
    peak_bytes = device_memory_peak(device)
    t_window = time.perf_counter()
    workload.release()
    gc.collect()
    checks = workload.check()
    mine = {"peak_bytes": peak_bytes, "attempted": window["attempted"],
            "failed": window["failed"]}
    if ranks.rank != 0:
        ranks.report(mine)
        return None
    print(f"port_bench: set-up {setup_s:.1f} s, window and trace "
          f"{t_window - start - setup_s:.1f} s, check {time.perf_counter() - t_window:.1f} s",
          file=sys.stderr)
    every = [mine] + ranks.reports()
    peak_bytes = max(r["peak_bytes"] for r in every)
    attempted = sum(r["attempted"] for r in every)
    failed = sum(r["failed"] for r in every)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    run = Run(config, window, setup_s, peak_bytes, summary, peaks.peak(name), arch, ranks.world)
    metrics = {}
    for m in reg.metrics(cell, trace):
        value = reg.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = {k: {"value": checks[k], "limit": v} for k, v in limits.items()}
    correct = (failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in compared.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name,
           "count": ranks.world, "memory_peak_bytes": peak_bytes}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        line["breakdown"] = summary.breakdown()
    line["checked"] = compared
    return line


def _rank(ranks: Ranks, device: torch.device, cell: str, seed: int, seconds: float,
          trace: bool, root: str, start: float) -> Optional[Dict]:
    """One rank of a multi-card run (`launch`'s target): its part of the
    run, then the look for JAX's modules in this rank's process."""
    line = run_cell(cell, seed, seconds, trace, device, root, start, ranks)
    found = banned_modules()
    if found:
        print(f"port_bench: rank {ranks.rank} loaded modules of JAX or the JAX package: "
              f"{found}", file=sys.stderr)
        raise SystemExit(3)
    return line


def run_chips(cell: str, seed: int, seconds: float, trace: bool, chips: int) -> Dict:
    """One run of `cell` on `chips` cards: in this process on one, one
    process a card on more."""
    if chips == 1:
        return run_cell(cell, seed, seconds, trace, torch.device("cuda", 0))
    build_kernels(torch.device("cuda"))
    return launch(chips, "cuda", _rank, (cell, seed, seconds, trace, ROOT, PROCESS_START))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    reg = Registry(ROOT)
    entry = reg.cell(args.workload)
    chips = entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        reg.arch(reg.config(entry["config"]))
        line = run_chips(args.workload, args.seed, args.seconds, bool(args.trace), chips)
    except UnknownArch as e:
        print(f"port_bench: {e.args[0]}", file=sys.stderr)
        return 1
    except RankFailed as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3 if e.code == 3 else 1
    found = banned_modules()
    if found:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in line["checked"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
