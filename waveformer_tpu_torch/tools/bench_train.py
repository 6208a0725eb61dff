"""Sustained training throughput on one card: the repository's
`tools/bench_train.py` for the port, with its two modes and flags.

    python -m waveformer_tpu_torch.tools.bench_train --device-only [--batch 1] [--remat]
    python -m waveformer_tpu_torch.tools.bench_train [--steps 60 --epochs 3 --batch 1
        --workers 12 --aug train|train_fast --window 4 --remat] [--device cuda|cpu]

Both modes train the flagship network (`Config().network`, 128³ patches,
seed-0 weights) in bf16 on fp32 masters: the module is built in fp32 and
cast once its weights are the masters (`training/state.py::master_params`).
`--remat` sets `use_checkpoint=True`.

`--device-only`: chained train steps (`make_train_step` with `dice_ce_loss`;
AdamW at lr 1e-4, weight decay 1e-2, clip 12) on one resident batch of
standard-normal data and zero labels, drawn with `numpy.random.default_rng(0)`
as the JAX tool draws it. One warm-up step, then `--steps` steps. The line:
`ms_per_step` and `steps_per_s` from the wall clock after the last loss is
read back; `device_ms_per_step` from CUDA events around the steps;
`peak_mem_gib` from `torch.cuda.max_memory_allocated`; the first and last
losses and the first step's unclipped gradient norm.

Pipeline mode: the port's `Trainer` (spawned `PrefetchLoader` workers, the
`--aug` augmentation, pinned upload, losses read back `--window` steps
late) for `--epochs` epochs of `--steps` steps, no validation, on four
synthetic preprocessed (4, 150, 180, 145) cases
(`tools/synthetic_cases.py::write_training_cases`) in a temporary
directory. The line: the JAX tool's keys (the seconds of each epoch from
`Trainer.epoch_times`, the warm epochs' steps/s and ms/step), the warm
epochs' share of time spent waiting for the loader, the peak memory, the
host's core counts (`nproc_host` is `os.cpu_count()`, `cpus_usable` the
cores this process may run on), and the losses the trainer logged (their
count, whether all are finite, the first and the last). `--workers` is
used as given.

Every run prints one JSON line. Torch is imported inside `main`: the
loader's spawned workers import this module again and must not load it.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

PATCH = (128, 128, 128)
CASE_SHAPE = (4, 150, 180, 145)
N_CASES = 4
SEED = 0
# the JAX tool's optimizer (`tools/bench_train.py:95`)
LR, WEIGHT_DECAY, GRAD_CLIP = 1e-4, 1e-2, 12.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--workers", type=int, default=12)
    ap.add_argument("--aug", default="train_fast", choices=["train", "train_fast"])
    ap.add_argument("--device-only", action="store_true",
                    help="chained train steps on one resident batch (no pipeline)")
    ap.add_argument("--window", type=int, default=4,
                    help="Trainer.loss_readback_window (0 = read the loss every step)")
    ap.add_argument("--remat", action="store_true",
                    help="use_checkpoint=True (block + full-res conv remat)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the "
                    "kernels' plain versions)")
    return ap.parse_args(argv)


def card_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def peak_mem_gib(device):
    """Peak memory allocated on a CUDA device since the last reset, GiB
    (None on the CPU)."""
    import torch

    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def device_only(args, model, device, patch, in_chans) -> dict:
    """Chained steps on one resident batch; returns the line."""
    import numpy as np
    import torch

    from waveformer_tpu_torch.training.losses import dice_ce_loss
    from waveformer_tpu_torch.training.state import (
        TrainState, make_optimizer, make_train_step, master_params)
    from waveformer_tpu_torch.training.trainer import step_seed

    model.train()
    tx = make_optimizer(lr=LR, weight_decay=WEIGHT_DECAY, grad_clip_norm=GRAD_CLIP)
    state = TrainState.create(master_params(model, torch.bfloat16), tx)
    step = make_train_step(model, dice_ce_loss)
    rng = np.random.default_rng(SEED)
    batch = {
        "data": torch.from_numpy(rng.standard_normal((args.batch, *patch, in_chans))
                                 .astype(np.float32)).to(device),
        "seg": torch.zeros((args.batch, *patch, 1), dtype=torch.int32, device=device),
    }
    gen = torch.Generator(device=device)

    def one():
        # drop-path masks drawn as the trainer draws them
        gen.manual_seed(step_seed(SEED, state.step))
        return step(state, batch, gen)[1]

    reset_peak(device)
    first = one()  # warm-up: cuDNN's algorithm choice, the AdamW state
    loss_first, norm_first = float(first["loss"]), float(first["grad_norm"])
    timed = device.type == "cuda"
    if timed:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.time()
    if timed:
        start.record()
    for _ in range(args.steps):
        m = one()
    if timed:
        end.record()
    loss_last = float(m["loss"])  # the readback waits for every step
    dt = (time.time() - t0) / args.steps
    device_ms = None
    if timed:
        torch.cuda.synchronize(device)
        device_ms = start.elapsed_time(end) / args.steps
    return {
        "mode": "device_only", "batch": args.batch, "remat": args.remat,
        "steps": args.steps, "ms_per_step": dt * 1e3, "steps_per_s": 1.0 / dt,
        "device_ms_per_step": device_ms, "peak_mem_gib": peak_mem_gib(device),
        "loss_first": loss_first, "loss_last": loss_last, "grad_norm_first": norm_first,
        "card": card_name(device),
    }


def pipeline(args, model, device, patch, case_shape) -> dict:
    """`Trainer.train` on synthetic preprocessed cases; returns the line."""
    import numpy as np
    import torch

    from waveformer_tpu_torch.data.dataset import MedicalDataset
    from waveformer_tpu_torch.tools.synthetic_cases import write_training_cases
    from waveformer_tpu_torch.training.trainer import Trainer

    with tempfile.TemporaryDirectory(prefix="bench_train_") as root:
        fullres = os.path.join(root, "fullres")
        names = write_training_cases(fullres, n=N_CASES, shape=tuple(case_shape[1:]),
                                     seed=SEED)
        ds = MedicalDataset(fullres, names, unpack=True, num_processes=1)
        trainer = Trainer(
            model,
            max_epochs=args.epochs,
            batch_size=args.batch,
            val_every=10**9,
            num_steps_per_epoch=args.steps,
            patch_size=patch,
            logdir=os.path.join(root, "logs"),
            num_workers=args.workers,
            augmentation=args.aug,
            resume=False,
            compute_dtype=torch.bfloat16,
        )
        trainer.loss_readback_window = args.window
        reset_peak(device)
        trainer.train(ds, ds)
        with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
            losses = [r["value"] for r in map(json.loads, f) if r["tag"] == "training_loss"]
    times = trainer.epoch_times
    warm = times[1:] or times
    warm_s = sum(s for _, s, _ in warm)
    sps = sum(n for n, _, _ in warm) / warm_s
    return {
        "mode": "pipeline", "aug": args.aug, "batch": args.batch,
        "window": args.window, "remat": args.remat,
        "workers": args.workers, "nproc_host": os.cpu_count(),
        "cpus_usable": len(os.sched_getaffinity(0)),
        "epoch_secs": [s for _, s, _ in times],
        "warm_steps_per_s": sps, "warm_ms_per_step": 1e3 / sps,
        "loader_wait_share": sum(w for _, _, w in warm) / warm_s,
        "peak_mem_gib": peak_mem_gib(device),
        "loss_count": len(losses), "losses_finite": bool(np.isfinite(losses).all()),
        "loss_first": losses[0], "loss_last": losses[-1],
        "card": card_name(device),
    }


def main(argv=None, network=None, patch=PATCH, case_shape=CASE_SHAPE, weights=None) -> dict:
    """Run the tool and print its line; returns the line. The network
    kwargs, patch, case shape and initial fp32 weights (a state dict) are
    the flagship's seed-0 ones unless a caller (a test at a tiny size)
    passes others."""
    args = parse_args(argv)
    from waveformer_tpu_torch.config import Config
    from waveformer_tpu_torch.device import resolve_device
    from waveformer_tpu_torch.models import create_waveformer

    device = resolve_device(args.device)
    kw = dict(network if network is not None else Config().network.model_kwargs())
    if args.remat:
        kw["use_checkpoint"] = True
    model = create_waveformer(kw, device=device, seed=SEED)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    patch = tuple(patch)
    if args.device_only:
        line = device_only(args, model, device, patch, kw["in_chans"])
    else:
        line = pipeline(args, model, device, patch, case_shape)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
