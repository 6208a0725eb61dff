"""Where the time of one main-path forward goes, on the CUDA device.

    python -m waveformer_tpu_torch.trace_forward [--batch 8] [--out DIR]

Builds the flagship WaveFormer (bf16, random weights from a seed), times a
batch-8 128³ forward with CUDA events, then traces a few forwards with
`torch.profiler` and sums the device time of each kernel. Prints one JSON
line: forward ms, the device-busy share of the traced wall time, and the
device time per category (the two hand-written kernels, convolutions,
matmuls, norms and reductions, elementwise, copies, resize). The full
per-kernel table goes to `DIR/trace_forward.txt`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from waveformer_tpu_torch.config import Config
from waveformer_tpu_torch.models import create_waveformer

# first matching substring of the lower-cased kernel name wins
CATEGORIES = [
    ("window_attention", ("window_attention",)),
    ("dwconv3", ("dwconv3",)),
    ("conv", ("conv", "cudnn", "implicit", "xmma_fprop", "dgrad", "wgrad", "winograd")),
    ("matmul", ("gemm", "cutlass", "matmul", "nvjet", "sm90_xmma")),
    ("norm_reduce", ("norm", "reduce", "welford", "var_mean", "softmax")),
    ("resize", ("upsample", "interp")),
    ("copy", ("copy", "memcpy", "memset", "cat", "flip", "index", "gather", "pad")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "gelu", "leaky", "sigmoid")),
]


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=".")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_forward: no CUDA device")

    model = create_waveformer(Config().network.model_kwargs(), dtype=torch.bfloat16, seed=0,
                              io_layout="channels_first")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(args.batch, 4, 128, 128, 128, device="cuda", generator=g)
    x = x.to(torch.bfloat16)
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            model(x)
        end.record()
        torch.cuda.synchronize()
        fwd_ms = start.elapsed_time(end) / args.iters

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel.setdefault(evt.name, [0.0, 0])
            per_kernel[evt.name][0] += evt.time_range.elapsed_us() / 1e3
            per_kernel[evt.name][1] += 1
    device_ms = sum(v[0] for v in per_kernel.values())
    cats = {}
    for name, (ms, _) in per_kernel.items():
        cats[category(name)] = cats.get(category(name), 0.0) + ms / args.iters
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trace_forward.txt"), "w") as f:
        f.write(f"{torch.cuda.get_device_name(0)}  batch {args.batch}  iters {args.iters}\n")
        for name, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
            f.write(f"{ms / args.iters:10.3f} ms/fwd {n // args.iters:6d} calls  "
                    f"{category(name):12s} {name[:160]}\n")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch,
        "forward_ms": fwd_ms,
        "traced_wall_ms_per_forward": wall_ms / args.iters,
        "device_ms_per_forward": device_ms / args.iters,
        "device_busy_share": device_ms / wall_ms,
        "category_ms_per_forward": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
    }), flush=True)


if __name__ == "__main__":
    main()
