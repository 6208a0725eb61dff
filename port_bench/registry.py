"""Where the benchmark finds its parts, by the names `BENCHMARK.json` gives.

  configs:   the `file` of the configuration's entry (JSON)
  archs:     port_bench/archs/<arch>.py for a configuration whose `arch`
             key is <arch> ("waveformer" without the key): everything the
             harness knows of one model (its module's docstring)
  traffic:   port_bench/traffic/<traffic>.json, a data file whose `kind`
             names the general driver port_bench/kinds/<kind>.py
  cell:      port_bench/workloads/<cell>.json, the limits of its check
  metrics:   port_bench/metrics/<stem>.py for a metric named <stem> or
             <stem>.<suffix>; its `read(run)` returns a number or None

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files and entries, never by editing one that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

DEFAULT_ARCH = "waveformer"


class UnknownArch(KeyError):
    """A configuration names an architecture that has no module."""


class Registry:
    """The parts of the benchmark in the checkout at `root`."""

    def __init__(self, root: str):
        self.root = root
        self.pkg = os.path.join(root, "port_bench")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        with open(os.path.join(self.pkg, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def limits(self, cell: str) -> Dict[str, float]:
        with open(os.path.join(self.pkg, "workloads", f"{cell}.json")) as f:
            return json.load(f)["limits"]

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The metrics a run of `cell` reports: its end-to-end metrics, or
        with `trace` the per-layer metrics that list it (or, listing no
        cells, move one of its end-to-end metrics)."""
        e2e = [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def module(self, kind: str, name: str) -> ModuleType:
        """port_bench/<kind>/<name>.py as a module."""
        path = os.path.join(self.pkg, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"port_bench.{kind}.{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def arch(self, config: Dict) -> ModuleType:
        name = config.get("arch", DEFAULT_ARCH)
        if not os.path.exists(os.path.join(self.pkg, "archs", f"{name}.py")):
            raise UnknownArch(f"no architecture {name!r}: port_bench/archs/{name}.py is missing")
        return self.module("archs", name)

    def kind(self, name: str) -> ModuleType:
        return self.module("kinds", name)

    def reader(self, metric: str) -> ModuleType:
        return self.module("metrics", metric.split(".")[0])
