"""What the kernels' roofline readers share."""

from __future__ import annotations

import re

from port_bench import flops


def kernel_base(name: str) -> str:
    """A device kernel's name without its return type, namespaces, template
    arguments and parameters: "void (anonymous namespace)::k<16>(P)" → "k"."""
    name = name.replace("(anonymous namespace)::", "").strip()
    name = re.sub(r"^void\s+", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


def kernel_share(run, kernel: str, names) -> float:
    """Percent of the roofline over the traced window for `kernel`'s calls,
    timed by the device activities whose base name is in `names`; None
    where the window ran none of them."""
    t, peak, w = run.trace, run.peak, run.window
    if t is None or peak is None or not w.get("forwards"):
        return None
    device = sum(a.dur for a in t.activities if kernel_base(a.name) in names) / 1e9
    if device <= 0:
        return None
    batch = w["patches"] // w["forwards"]
    calls = flops.model_counts(run.arch, run.config["network"], batch)["calls"]
    bound = flops.bound_seconds(kernel, calls, peak["bf16_flops"], peak["hbm_bytes"])
    return 100.0 * bound * w["forwards"] / device
