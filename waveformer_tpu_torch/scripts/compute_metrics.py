"""Step 5 — per-case Dice + HD95 on saved predictions vs raw ground truth
(reference `5_compute_metrics.py`).

    python -m waveformer_tpu_torch.scripts.compute_metrics --config config.yaml \
        [--pred-dir DIR] [--gt-dir DIR] [--split test|val] [--out result_metrics.npy]
        [--device cuda|cpu]

The CLI and output of `waveformer_tpu/scripts/compute_metrics.py`: a
(cases, rows, 2) `.npy` of [dice, hd95], one line per case, the per-class
mean±std and the AVG line, all computed on the host in float64. Each
case's Dice is also recomputed with `dice_torch` on `--device` (the CUDA
device unless asked otherwise), and the script raises if the two disagree
by more than 1e-6.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from waveformer_tpu_torch.config import load_config
from waveformer_tpu_torch.data.dataset import get_train_val_test_loader_from_train
from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.metrics import (
    brats_case_metrics,
    convert_labels_brats,
    dice_torch,
    multiclass_case_metrics,
)
from waveformer_tpu_torch.utils import nifti

# host Dice (float64) against `dice_torch` (fp32 sums, exact below 2^24 voxels)
DICE_DEVICE_TOL = 1e-6


def binary_stack(labels: np.ndarray, label_mode: str, out_channels: int) -> np.ndarray:
    """The (rows, *spatial) binary masks that the metric rows score."""
    if label_mode == "brats":
        return convert_labels_brats(labels)
    return np.stack([labels == c for c in range(1, out_channels)])


def check_dice_on_device(gt, pred, rows: np.ndarray, label_mode: str,
                         out_channels: int, device: torch.device) -> None:
    """Recompute the Dice column with `dice_torch` on `device` where both
    masks are non-empty (elsewhere `cal_metric` reports its [0, 50])."""
    g = binary_stack(gt, label_mode, out_channels)
    p = binary_stack(pred, label_mode, out_channels)
    got = dice_torch(torch.from_numpy(p).to(device), torch.from_numpy(g).to(device))
    got = got.double().cpu().numpy()
    both = (p.reshape(len(p), -1).sum(1) > 0) & (g.reshape(len(g), -1).sum(1) > 0)
    err = np.abs(got[both] - rows[both, 0])
    if err.size and err.max() > DICE_DEVICE_TOL:
        raise RuntimeError(f"dice_torch disagrees with the host dice by {err.max():.3g}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--pred-dir", default=None)
    ap.add_argument("--gt-dir", default=None,
                    help="raw dataset root containing {case}/seg.nii.gz")
    ap.add_argument("--split", choices=("test", "val"), default="test")
    ap.add_argument("--out", default="result_metrics.npy")
    ap.add_argument("--device", default=None,
                    help="torch device of the Dice cross-check (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    pred_dir = args.pred_dir or cfg.prediction.prediction_save
    gt_dir = args.gt_dir or cfg.raw_data_dir
    label_mode = cfg.extra.get("label_mode", "brats")

    _, val_ds, test_ds = get_train_val_test_loader_from_train(
        cfg.data_dir,
        test_list_path=os.path.join(cfg.data_list_path, "test_list.pkl"),
        split_dir=os.path.join(cfg.data_list_path, cfg.split_path),
        unpack=False,
    )
    names = (test_ds if args.split == "test" else val_ds).case_names
    n_rows = 3 if label_mode == "brats" else cfg.network.out_channels - 1
    results = np.zeros((len(names), n_rows, 2), np.float64)
    for i, name in enumerate(names):
        gt = nifti.load(os.path.join(gt_dir, name, "seg.nii.gz")).data.T
        pred = nifti.load(os.path.join(pred_dir, name + ".nii.gz")).data.T
        if label_mode == "brats":
            results[i] = brats_case_metrics(
                gt, pred, cfg.prediction.raw_spacing
            )
        else:
            results[i] = multiclass_case_metrics(
                gt, pred, cfg.network.out_channels, cfg.prediction.raw_spacing
            )
        check_dice_on_device(gt, pred, results[i], label_mode,
                             cfg.network.out_channels, device)
        print(name, results[i].tolist())

    np.save(args.out, results)
    mean, std = results.mean(axis=0), results.std(axis=0)
    class_names = (
        ("TC", "WT", "ET") if label_mode == "brats"
        else tuple(f"class{c}" for c in range(1, n_rows + 1))
    )
    for c, cls in enumerate(class_names):
        print(
            f"{cls}: dice {mean[c, 0]:.4f}±{std[c, 0]:.4f} "
            f"hd95 {mean[c, 1]:.2f}±{std[c, 1]:.2f}"
        )
    print(
        f"AVG: dice {results[:, :, 0].mean():.4f} "
        f"hd95 {results[:, :, 1].mean():.2f}"
    )
    return results


if __name__ == "__main__":
    main()
