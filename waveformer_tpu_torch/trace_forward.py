"""Where the time of one main-path forward (or training step) goes, on the
CUDA device.

    python -m waveformer_tpu_torch.trace_forward [--batch 8] [--out DIR]
    python -m waveformer_tpu_torch.trace_forward --train [--batch 2] [--out DIR]
    python -m waveformer_tpu_torch.trace_forward --ssl [--batch 2] [--out DIR]

Builds the flagship WaveFormer (bf16, random weights from a seed), times a
batch-8 128³ forward with CUDA events, then traces a few forwards with
`torch.profiler` and sums the device time of each kernel. Prints one JSON
line: forward ms, the device-busy share of the traced wall time, and the
device time per category (the two hand-written kernels, convolutions,
matmuls, norms and reductions, elementwise, copies, resize). The full
per-kernel table goes to `DIR/trace_forward.txt`.

With `--train` it does the same for training steps instead (channels-last
batches of random labels, the step of `training.state.make_train_step`:
forward, DiceCE, backward, clip, AdamW on fp32 masters), and adds the
device time under each kernel's backward (`_WindowAttentionBackward`,
`_DWConv3Backward`: their plain compositions). From an fp32 build, the
masters are taken before the module is cast to bf16, as `Trainer` does.

With `--ssl` it traces SSL pretraining steps (`training.ssl.make_ssl_step`)
of the pretraining script's default `SSLViT` (ViT-B at 96³, patch 16, the
vae decoder, 4 channels) in bf16 on fp32 masters: two forwards on resident
random views, NT-Xent × L1 + L1, backward, AdamW.
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
    ("sdpa", ("flash", "fmha", "efficient_attention")),
    ("optimizer_foreach", ("multi_tensor",)),
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
    ap.add_argument("--batch", type=int, default=None, help="default 8, or 2 with --train")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--train", action="store_true", help="trace training steps")
    ap.add_argument("--ssl", action="store_true", help="trace SSL pretraining steps")
    ap.add_argument("--out", default=".")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_forward: no CUDA device")
    train = args.train or args.ssl
    args.batch = args.batch or (2 if train else 8)

    g = torch.Generator(device="cuda").manual_seed(0)
    if args.train:
        from waveformer_tpu_torch.training.losses import dice_ce_loss
        from waveformer_tpu_torch.training.state import (
            TrainState, make_optimizer, make_train_step, master_params)

        model = create_waveformer(Config().network.model_kwargs(), seed=0).train()
        state = TrainState.create(master_params(model, torch.bfloat16), make_optimizer())
        step = make_train_step(model, dice_ce_loss)
        batch = {"data": torch.randn(args.batch, 128, 128, 128, 4, device="cuda", generator=g),
                 "seg": torch.randint(0, 4, (args.batch, 128, 128, 128, 1), device="cuda",
                                      generator=g, dtype=torch.int32)}
        run, context = (lambda: step(state, batch)), torch.enable_grad
    elif args.ssl:
        from waveformer_tpu_torch.models.ssl import create_ssl_vit
        from waveformer_tpu_torch.training.ssl import make_ssl_step
        from waveformer_tpu_torch.training.state import (
            TrainState, make_optimizer, master_params)

        model = create_ssl_vit(seed=0, in_channels=4).train()
        state = TrainState.create(master_params(model, torch.bfloat16), make_optimizer(
            lr=4e-4, weight_decay=1e-5, grad_clip_norm=None))
        step = make_ssl_step(model)
        v1, v2, gt = (torch.randn(args.batch, 96, 96, 96, 4, device="cuda", generator=g)
                      for _ in range(3))
        run, context = (lambda: step(state, v1, v2, gt)), torch.enable_grad
    else:
        model = create_waveformer(Config().network.model_kwargs(), dtype=torch.bfloat16,
                                  seed=0, io_layout="channels_first")
        x = torch.randn(args.batch, 4, 128, 128, 128, device="cuda", generator=g)
        x = x.to(torch.bfloat16)
        run, context = (lambda: model(x)), torch.inference_mode
    with context():
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            run()
        end.record()
        torch.cuda.synchronize()
        fwd_ms = start.elapsed_time(end) / args.iters

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = {}
    for evt in prof.events():
        # a step's spans (`utils.profiling.span`) also show as device ranges
        if evt.device_type == torch.autograd.DeviceType.CUDA and not evt.is_user_annotation:
            per_kernel.setdefault(evt.name, [0.0, 0])
            per_kernel[evt.name][0] += evt.time_range.elapsed_us() / 1e3
            per_kernel[evt.name][1] += 1
    device_ms = sum(v[0] for v in per_kernel.values())
    cats = {}
    for name, (ms, _) in per_kernel.items():
        cats[category(name)] = cats.get(category(name), 0.0) + ms / args.iters
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trace_forward.txt"), "w") as f:
        f.write(f"{torch.cuda.get_device_name(0)}  batch {args.batch}  iters {args.iters}"
                f"{'  SSL steps' if args.ssl else '  training steps' if args.train else ''}\n")
        for name, (ms, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
            f.write(f"{ms / args.iters:10.3f} ms/{'step' if train else 'fwd'} "
                    f"{n // args.iters:6d} calls  "
                    f"{category(name):12s} {name[:160]}\n")
    unit = "step" if train else "forward"
    row = {
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch,
        f"{unit}_ms": fwd_ms,
        f"traced_wall_ms_per_{unit}": wall_ms / args.iters,
        f"device_ms_per_{unit}": device_ms / args.iters,
        "device_busy_share": device_ms / wall_ms,
        f"category_ms_per_{unit}": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
    }
    if args.train:
        # device time under each kernel's autograd node (its plain backward)
        row["backward_ms_per_step"] = {
            node: sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                      for e in prof.key_averages()
                      if e.key == f"autograd::engine::evaluate_function: {node}")
            / 1e3 / args.iters
            for node in ("_WindowAttentionBackward", "_DWConv3Backward")}
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
