"""Runnable dataset-family drivers: the repository's
`examples/{brats2023,abdomen_ct,liver_ct}/run_example.py` for the port.

    python -m waveformer_tpu_torch.examples.brats2023 --workdir /tmp/brats_demo
    python -m waveformer_tpu_torch.examples.abdomen_ct --workdir /tmp/abdomen_demo
    python -m waveformer_tpu_torch.examples.liver_ct --workdir /tmp/liver_demo

Each driver synthesizes a small raw dataset of its family (or reads
`--raw-dir`), then runs the five steps through the port's scripts:
`scripts.preprocess` with the family's dataset driver, `scripts.train`,
`scripts.predict` on the validation split without TTA, and
`scripts.compute_metrics`, on the CUDA device unless `--device` names
another (`--device cpu` runs the kernels' plain versions). The scripts
are imported inside `run`: the training loader's spawned workers import
the driver's module again and must not load torch.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Sequence

import numpy as np


def arguments(description: str, workdir: str, raw_help: str) -> argparse.ArgumentParser:
    """The JAX drivers' flags, with `--device` in place of `--platform`."""
    ap = argparse.ArgumentParser(description=description,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default=workdir)
    ap.add_argument("--raw-dir", default=None, help=raw_help)
    ap.add_argument("--cases", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40,
                    help="train steps per epoch (lower for smoke runs)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs the "
                    "kernels' plain versions)")
    return ap


def run(args: argparse.Namespace,
        make_synthetic_dataset: Callable[[str, int], None],
        preprocess_args: Sequence[str],
        write_config: Callable[[str, str, int, int], str],
        notes: Sequence[str]) -> np.ndarray:
    """The five steps in `args.workdir`; `notes` are the messages of steps
    2, 3 and 5. Returns the (cases, rows, 2) metrics array, also saved as
    `result_metrics.npy`."""
    from waveformer_tpu_torch.device import resolve_device

    device = ["--device", str(resolve_device(args.device))]
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)

    raw_dir = args.raw_dir
    if raw_dir is None:
        raw_dir = os.path.join(workdir, "raw")
        if not os.path.isdir(raw_dir):
            print(f"[1/5] synthesizing {args.cases} cases -> {raw_dir}")
            make_synthetic_dataset(raw_dir, args.cases)
    else:
        print("[1/5] using existing raw dataset", raw_dir)

    from waveformer_tpu_torch.scripts import compute_metrics, predict, preprocess, train

    print(f"[2/5] {notes[0]}")
    preprocess.main([
        "--raw-dir", raw_dir,
        "--out-dir", os.path.join(workdir, "fullres"),
        *preprocess_args,
        "--num-processes", "1",
    ])
    config_path = write_config(workdir, raw_dir, args.epochs, args.steps)

    print(f"[3/5] {notes[1]}")
    train.main(["--config", config_path, *device])

    print("[4/5] predicting validation split")
    predict.main(["--config", config_path, "--split", "val", "--no-tta", *device])

    print(f"[5/5] {notes[2]}")
    results = compute_metrics.main([
        "--config", config_path, "--split", "val",
        "--out", os.path.join(workdir, "result_metrics.npy"), *device,
    ])
    print("done; artifacts in", workdir)
    return results
