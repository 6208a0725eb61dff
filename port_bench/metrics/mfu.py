"""The whole step's share of the cards' bf16 tensor peak: the reference's
FLOPs of the work the traced window did (patch forwards, or training
samples of every rank at three forwards each), over the window's seconds,
over the peak (`port_bench.peaks`) times the cards the cell uses. The
FLOPs are counted once per configuration over the plain reference of its
architecture (`port_bench.flops`), whatever implements the forward."""

from port_bench import flops


def read(run):
    t, peak = run.trace, run.peak
    if t is None or peak is None or t.window_s <= 0:
        return None
    counts = flops.model_counts(run.arch, run.config["network"], 1)
    w = run.window
    if "samples" in w:
        work = counts["train_flops"] * w["samples"]
    else:
        work = counts["forward_flops"] * w["patches"]
    return 100.0 * work / t.window_s / (run.chips * peak["bf16_flops"]) if work else None
