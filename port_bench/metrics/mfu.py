"""The whole step's share of the card's bf16 tensor peak: the reference's
FLOPs of the work the traced window did (patch forwards, or training
samples at three forwards each), over the window's seconds, over the peak
(`port_bench.peaks`). The FLOPs are counted once per configuration over
the plain reference (`port_bench.flops`), whatever implements the forward."""

from port_bench import flops


def read(run):
    t, peak = run.trace, run.peak
    if t is None or peak is None or t.window_s <= 0:
        return None
    counts = flops.model_counts(run.config["network"], 1)
    w = run.window
    if "samples" in w:
        work = counts["train_flops"] * w["samples"]
    else:
        work = counts["forward_flops"] * w["patches"]
    return 100.0 * work / t.window_s / peak["bf16_flops"] if work else None
