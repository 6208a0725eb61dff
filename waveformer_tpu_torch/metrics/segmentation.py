"""Segmentation metrics: Dice, HD95, surface distances, confusion stats.

Replaces the reference's medpy-backed metric stack
(`light_training/evaluation/metric.py:25-405`, `5_compute_metrics.py:15-37`)
with numpy/scipy (host) + torch (on-device validation dice). A copy of
`waveformer_tpu/metrics/segmentation.py`, with `dice_torch` in place of
`dice_jax`:

  * `dice` / `hausdorff_distance_95` reproduce medpy `binary.dc` /
    `binary.hd95` semantics (binary erosion surface extraction,
    EDT distances, 95th percentile of the symmetric distance set).
  * `cal_metric` keeps the reference's empty-mask conventions
    (`5_compute_metrics.py:15-21`: non-empty → [dice, hd95];
    otherwise [0, 50]).
  * `convert_labels_brats` is the TC/WT/ET conversion (`3_train.py:104-112`).
  * `dice_torch` is the per-batch binary dice for validation on the
    device, the counterpart of the JAX package's `dice_jax`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


# --------------------------------------------------------------------------- #
# overlap metrics (numpy)
# --------------------------------------------------------------------------- #


class ConfusionStats:
    """tp/fp/tn/fn bundle + existence flags
    (capability of `evaluation/metric.py:25-102`)."""

    def __init__(self, pred: np.ndarray, gt: np.ndarray):
        p = np.asarray(pred).astype(bool)
        g = np.asarray(gt).astype(bool)
        self.tp = int(np.count_nonzero(p & g))
        self.fp = int(np.count_nonzero(p & ~g))
        self.fn = int(np.count_nonzero(~p & g))
        self.tn = int(np.count_nonzero(~p & ~g))
        # existence flags (`evaluation/metric.py:71-78`): which degenerate
        # masks make a rate undefined
        self.pred_empty = self.tp + self.fp == 0
        self.pred_full = self.fn + self.tn == 0
        self.gt_empty = self.tp + self.fn == 0
        self.gt_full = self.fp + self.tn == 0

    @property
    def n(self):
        return self.tp + self.fp + self.fn + self.tn

    def dice(self) -> float:
        denom = 2 * self.tp + self.fp + self.fn
        return 2 * self.tp / denom if denom else 0.0

    def jaccard(self) -> float:
        denom = self.tp + self.fp + self.fn
        return self.tp / denom if denom else 0.0

    def precision(self) -> float:
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def recall(self) -> float:
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def specificity(self) -> float:
        denom = self.tn + self.fp
        return self.tn / denom if denom else 0.0

    def accuracy(self) -> float:
        return (self.tp + self.tn) / self.n if self.n else 0.0

    def fscore(self, beta: float = 1.0) -> float:
        p, r = self.precision(), self.recall()
        denom = beta**2 * p + r
        return (1 + beta**2) * p * r / denom if denom else 0.0

    # ---- rate family (`evaluation/metric.py:222-270`) ----
    def false_positive_rate(self) -> float:
        return 1.0 - self.specificity()

    def false_omission_rate(self) -> float:
        denom = self.fn + self.tn
        return self.fn / denom if denom else 0.0

    def false_negative_rate(self) -> float:
        return 1.0 - self.recall()

    def true_negative_rate(self) -> float:
        return self.specificity()

    def false_discovery_rate(self) -> float:
        return 1.0 - self.precision()

    def negative_predictive_value(self) -> float:
        return 1.0 - self.false_omission_rate()


def dice(pred: np.ndarray, gt: np.ndarray) -> float:
    """medpy `binary.dc` semantics."""
    return ConfusionStats(pred, gt).dice()


# --------------------------------------------------------------------------- #
# surface distances (numpy + scipy)
# --------------------------------------------------------------------------- #


def _surface(mask: np.ndarray) -> np.ndarray:
    from scipy import ndimage

    mask = mask.astype(bool)
    structure = ndimage.generate_binary_structure(mask.ndim, 1)
    eroded = ndimage.binary_erosion(mask, structure=structure, border_value=0)
    return mask & ~eroded


def surface_distances(
    pred: np.ndarray,
    gt: np.ndarray,
    voxelspacing: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Distances from pred surface voxels to the gt surface (medpy
    `__surface_distances` semantics)."""
    from scipy import ndimage

    pred_border = _surface(pred)
    gt_border = _surface(gt)
    if not pred_border.any() or not gt_border.any():
        raise ValueError("empty mask has no surface")
    dt = ndimage.distance_transform_edt(~gt_border, sampling=voxelspacing)
    return dt[pred_border]


def hausdorff_distance_95(
    pred: np.ndarray,
    gt: np.ndarray,
    voxelspacing: Optional[Sequence[float]] = None,
) -> float:
    """medpy `binary.hd95`: the 95th percentile of the POOLED symmetric
    surface-distance set, `np.percentile(np.hstack((d1, d2)), 95)` — not
    the max of two directed percentiles (golden-tested against the medpy
    transcription in `tools/gen_metric_goldens.py`)."""
    d1 = surface_distances(pred, gt, voxelspacing)
    d2 = surface_distances(gt, pred, voxelspacing)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def average_surface_distance(
    pred: np.ndarray,
    gt: np.ndarray,
    voxelspacing: Optional[Sequence[float]] = None,
) -> float:
    """medpy `binary.asd`."""
    return float(surface_distances(pred, gt, voxelspacing).mean())


def hausdorff_distance(
    pred: np.ndarray,
    gt: np.ndarray,
    voxelspacing: Optional[Sequence[float]] = None,
) -> float:
    """medpy `binary.hd`: max of the two directed maximum distances."""
    d1 = surface_distances(pred, gt, voxelspacing)
    d2 = surface_distances(gt, pred, voxelspacing)
    return float(max(d1.max(), d2.max()))


def average_surface_distance_symmetric(
    pred: np.ndarray,
    gt: np.ndarray,
    voxelspacing: Optional[Sequence[float]] = None,
) -> float:
    """medpy `binary.assd`: mean of the two directed means."""
    return float(
        np.mean(
            (
                average_surface_distance(pred, gt, voxelspacing),
                average_surface_distance(gt, pred, voxelspacing),
            )
        )
    )


# --------------------------------------------------------------------------- #
# name-keyed metric registry (`evaluation/metric.py:385-405`)
# --------------------------------------------------------------------------- #


def _registry_metric(rate_attr, nan_when):
    """Wrap a ConfusionStats rate with the reference's NaN-for-nonexisting
    convention: `nan_when(stats)` names the degenerate masks for which the
    rate is undefined (`evaluation/metric.py:81-270`)."""

    def metric_fn(test=None, reference=None, nan_for_nonexisting=True,
                  **kwargs):
        stats = ConfusionStats(test, reference)
        if nan_when(stats):
            return float("nan") if nan_for_nonexisting else 0.0
        return float(getattr(stats, rate_attr)())

    metric_fn.__name__ = rate_attr
    return metric_fn


def _registry_surface(fn):
    """Surface-distance metrics are undefined for empty OR full masks
    (`evaluation/metric.py:316-405`)."""

    def metric_fn(test=None, reference=None, nan_for_nonexisting=True,
                  voxel_spacing=None, **kwargs):
        stats = ConfusionStats(test, reference)
        if (
            stats.pred_empty or stats.pred_full
            or stats.gt_empty or stats.gt_full
        ):
            return float("nan") if nan_for_nonexisting else 0.0
        return float(fn(test, reference, voxel_spacing))

    metric_fn.__name__ = fn.__name__
    return metric_fn


def _registry_total(expr):
    def metric_fn(test=None, reference=None, **kwargs):
        s = ConfusionStats(test, reference)
        return float(expr(s))

    return metric_fn


# Keys reproduce the reference's registry verbatim, including the
# lowercase-t "total Negatives Reference" quirk (`metric.py:385-405`).
ALL_METRICS = {
    "False Positive Rate": _registry_metric(
        "false_positive_rate", lambda s: s.gt_full),
    "Dice": _registry_metric(
        "dice", lambda s: s.pred_empty and s.gt_empty),
    "Jaccard": _registry_metric(
        "jaccard", lambda s: s.pred_empty and s.gt_empty),
    "Hausdorff Distance": _registry_surface(hausdorff_distance),
    "Hausdorff Distance 95": _registry_surface(hausdorff_distance_95),
    "Precision": _registry_metric("precision", lambda s: s.pred_empty),
    "Recall": _registry_metric("recall", lambda s: s.gt_empty),
    "Avg. Symmetric Surface Distance": _registry_surface(
        average_surface_distance_symmetric),
    "Avg. Surface Distance": _registry_surface(average_surface_distance),
    "Accuracy": _registry_total(lambda s: s.accuracy()),
    "False Omission Rate": _registry_metric(
        "false_omission_rate", lambda s: s.pred_full),
    "Negative Predictive Value": _registry_metric(
        "negative_predictive_value", lambda s: s.pred_full),
    "False Negative Rate": _registry_metric(
        "false_negative_rate", lambda s: s.gt_empty),
    "True Negative Rate": _registry_metric(
        "true_negative_rate", lambda s: s.gt_full),
    "False Discovery Rate": _registry_metric(
        "false_discovery_rate", lambda s: s.pred_empty),
    "Total Positives Test": _registry_total(lambda s: s.tp + s.fp),
    "Total Negatives Test": _registry_total(lambda s: s.tn + s.fn),
    "Total Positives Reference": _registry_total(lambda s: s.tp + s.fn),
    "total Negatives Reference": _registry_total(lambda s: s.tn + s.fp),
}


def evaluate_metrics(
    pred: np.ndarray,
    gt: np.ndarray,
    metrics: Sequence[str],
    voxel_spacing: Optional[Sequence[float]] = None,
    nan_for_nonexisting: bool = True,
) -> dict:
    """Evaluate named registry metrics for one binary pair — the
    `Evaluator(metrics=[...])` surface of `evaluation/metric.py`."""
    out = {}
    for name in metrics:
        if name not in ALL_METRICS:
            raise KeyError(
                f"unknown metric {name!r}; available: {sorted(ALL_METRICS)}"
            )
        out[name] = ALL_METRICS[name](
            test=pred, reference=gt,
            nan_for_nonexisting=nan_for_nonexisting,
            voxel_spacing=voxel_spacing,
        )
    return out


# --------------------------------------------------------------------------- #
# BraTS conventions
# --------------------------------------------------------------------------- #


def convert_labels_brats(labels: np.ndarray) -> np.ndarray:
    """Label map → (3, *spatial) binary stack: TC, WT, ET
    (`3_train.py:104-112`; BraTS2023: 1=NCR, 2=ED, 3=ET)."""
    labels = np.asarray(labels)
    tc = (labels == 1) | (labels == 3)
    wt = tc | (labels == 2)
    et = labels == 3
    return np.stack([tc, wt, et]).astype(np.float32)


def cal_metric(
    gt: np.ndarray,
    pred: np.ndarray,
    voxel_spacing: Sequence[float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """Per-class [dice, hd95] with the reference's empty conventions
    (`5_compute_metrics.py:15-21`)."""
    if pred.sum() > 0 and gt.sum() > 0:
        return np.array(
            [dice(pred, gt), hausdorff_distance_95(pred, gt, voxel_spacing)]
        )
    return np.array([0.0, 50.0])


def brats_case_metrics(
    gt_labels: np.ndarray,
    pred_labels: np.ndarray,
    voxel_spacing: Sequence[float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """(3, 2) array of [dice, hd95] for TC/WT/ET
    (`5_compute_metrics.py:23-29` equivalent)."""
    gt = convert_labels_brats(gt_labels)
    pred = convert_labels_brats(pred_labels)
    return np.stack(
        [cal_metric(gt[c], pred[c], voxel_spacing) for c in range(3)]
    )


def multiclass_case_metrics(
    gt_labels: np.ndarray,
    pred_labels: np.ndarray,
    num_classes: int,
    voxel_spacing: Sequence[float] = (1.0, 1.0, 1.0),
) -> np.ndarray:
    """(num_classes-1, 2) array of [dice, hd95] for labels 1..C-1 — the
    generic (non-BraTS) evaluation the reference's per-dataset trainers
    compute class-by-class (e.g. AbdomenAtlas organs, liver/tumor)."""
    rows = []
    for c in range(1, num_classes):
        rows.append(
            cal_metric(gt_labels == c, pred_labels == c, voxel_spacing)
        )
    return np.stack(rows)


# --------------------------------------------------------------------------- #
# on-device dice for training validation
# --------------------------------------------------------------------------- #


def dice_torch(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Binary dice per leading batch dim, fp32, on the tensors' device.
    Empty-both → 1, one-empty → 0 (the training-validation convention at
    `3_train.py:121-130`)."""
    p = pred.to(torch.float32)
    g = gt.to(torch.float32)
    axes = tuple(range(1, p.ndim))
    inter = torch.sum(p * g, dim=axes)
    ps = torch.sum(p, dim=axes)
    gs = torch.sum(g, dim=axes)
    raw = 2 * inter / (ps + gs + eps)
    both_empty = (ps == 0) & (gs == 0)
    return torch.where(both_empty, torch.ones_like(raw), raw)
