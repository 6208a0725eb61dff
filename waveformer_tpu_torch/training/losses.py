"""Segmentation losses in PyTorch.

Port of `waveformer_tpu/training/losses.py`, function for function:
  * MONAI `DiceCELoss(to_onehot_y=True, softmax=True)`, the training loss
    (`3_train.py:72`, `monai/losses/dice.py:30,639`);
  * the nnUNet `SoftDiceLoss` family with batch dice
    (`light_training/loss/dice.py:9-56`, `compound_losses.py:8-103`);
  * deep-supervision weighting (`light_training/loss/deepsupervision.py:5-53`);
  * TopK CE (`light_training/loss/robust_ce_loss.py`).

All functions take logits `(B, *spatial, K)` channels-last and integer
labels `(B, *spatial, 1)` (or one-hot targets where stated); reductions run
in fp32 whatever the logits' dtype. The JAX functions' `axis_name` (a psum
of the batch-dice statistics over the mesh's data axis) has no counterpart
on one card and is left out.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """fp32 one-hot over a trailing class axis; a label outside
    [0, num_classes) gives a zero row, as `jax.nn.one_hot` does."""
    if labels.shape[-1] == 1:
        labels = labels[..., 0]
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long()[..., None] == classes).float()


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weight: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean CE over all voxels (torch `nn.CrossEntropyLoss` semantics)."""
    onehot = _one_hot(labels, logits.shape[-1])
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -(onehot * logp)
    if weight is not None:
        ce = ce * weight.float()
    return torch.mean(torch.sum(ce, dim=-1))


def soft_dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    include_background: bool = True,
    squared_pred: bool = False,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
    batch_dice: bool = False,
    apply_softmax: bool = True,
) -> torch.Tensor:
    """MONAI `DiceLoss(softmax=True, to_onehot_y=True)` semantics
    (`monai/losses/dice.py:30-200`): per-(sample, class) dice over spatial
    dims, mean-reduced; with `batch_dice` the statistics are summed over
    the batch first."""
    num_classes = logits.shape[-1]
    probs = F.softmax(logits.float(), dim=-1) if apply_softmax else logits.float()
    onehot = _one_hot(labels, num_classes)
    spatial = tuple(range(1, logits.ndim - 1))

    intersection = torch.sum(probs * onehot, dim=spatial)  # (B, K)
    if squared_pred:
        pred_sum = torch.sum(probs**2, dim=spatial)
        gt_sum = torch.sum(onehot**2, dim=spatial)
    else:
        pred_sum = torch.sum(probs, dim=spatial)
        gt_sum = torch.sum(onehot, dim=spatial)

    if batch_dice:
        intersection = torch.sum(intersection, dim=0, keepdim=True)
        pred_sum = torch.sum(pred_sum, dim=0, keepdim=True)
        gt_sum = torch.sum(gt_sum, dim=0, keepdim=True)

    if not include_background:
        intersection = intersection[:, 1:]
        pred_sum = pred_sum[:, 1:]
        gt_sum = gt_sum[:, 1:]

    dice = (2.0 * intersection + smooth_nr) / (pred_sum + gt_sum + smooth_dr)
    return torch.mean(1.0 - dice)


def dice_ce_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    lambda_dice: float = 1.0,
    lambda_ce: float = 1.0,
    include_background: bool = True,
    batch_dice: bool = False,
) -> torch.Tensor:
    """MONAI `DiceCELoss(to_onehot_y=True, softmax=True)` (`dice.py:639`)."""
    d = soft_dice_loss(logits, labels, include_background=include_background,
                       batch_dice=batch_dice)
    c = softmax_cross_entropy(logits, labels)
    return lambda_dice * d + lambda_ce * c


class DiceCELoss:
    """Callable config wrapper mirroring the reference's loss object."""

    def __init__(self, lambda_dice=1.0, lambda_ce=1.0, include_background=True,
                 batch_dice=False):
        self.kwargs = dict(lambda_dice=lambda_dice, lambda_ce=lambda_ce,
                           include_background=include_background, batch_dice=batch_dice)

    def __call__(self, logits, labels):
        return dice_ce_loss(logits, labels, **self.kwargs)


def dice_bce_loss(
    logits: torch.Tensor,
    region_targets: torch.Tensor,
    weight_ce: float = 1.0,
    weight_dice: float = 1.0,
    use_ignore_label: bool = False,
    batch_dice: bool = True,
    smooth: float = 1e-5,
) -> torch.Tensor:
    """Region-based sigmoid DC+BCE (reference `DC_and_BCE_loss`,
    `light_training/loss/compound_losses.py:60-100` with
    `MemoryEfficientSoftDiceLoss`, `loss/dice.py:58-115`).

    `region_targets` is one-hot over overlapping regions, channels-last
    (B, *spatial, K); with `use_ignore_label` the last channel marks voxels
    to exclude. The dice term is `-mean(dice)`, so the loss can be
    negative; `batch_dice` sums the statistics over the batch."""
    x = logits.float()
    t = region_targets.float()
    mask = None
    if use_ignore_label:
        mask = 1.0 - t[..., -1:]
        t = t[..., :-1]

    # BCE with logits (torch BCEWithLogitsLoss semantics), written out
    bce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    if mask is not None:
        ce = torch.sum(bce * mask) / torch.clamp(torch.sum(mask), min=1e-8)
    else:
        ce = torch.mean(bce)

    probs = torch.sigmoid(x)
    spatial = tuple(range(1, x.ndim - 1))
    if mask is not None:
        intersect = torch.sum(probs * t * mask, dim=spatial)
        sum_pred = torch.sum(probs * mask, dim=spatial)
        sum_gt = torch.sum(t * mask, dim=spatial)
    else:
        intersect = torch.sum(probs * t, dim=spatial)
        sum_pred = torch.sum(probs, dim=spatial)
        sum_gt = torch.sum(t, dim=spatial)
    if batch_dice:
        intersect = torch.sum(intersect, dim=0)
        sum_pred = torch.sum(sum_pred, dim=0)
        sum_gt = torch.sum(sum_gt, dim=0)
    dc = (2.0 * intersect + smooth) / torch.clamp(sum_gt + sum_pred + smooth, min=1e-8)
    return weight_ce * ce - weight_dice * torch.mean(dc)


def topk_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, k_percent: float = 10.0
) -> torch.Tensor:
    """nnUNet `TopKLoss` (`loss/robust_ce_loss.py`): mean over the top-k%
    highest-CE voxels of each sample."""
    onehot = _one_hot(labels, logits.shape[-1])
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -torch.sum(onehot * logp, dim=-1).reshape(logits.shape[0], -1)
    k = max(1, int(ce.shape[1] * k_percent / 100.0))
    return torch.mean(torch.topk(ce, k, dim=1).values)


def dice_topk_loss(logits, labels, k_percent=10.0, **dice_kwargs):
    """nnUNet `DC_and_topk_loss` (`loss/compound_losses.py:103`)."""
    return soft_dice_loss(logits, labels, **dice_kwargs) + topk_cross_entropy(
        logits, labels, k_percent
    )


def deep_supervision_weights(n_outputs: int) -> torch.Tensor:
    """nnUNet AutoDeepSupervision weights (`loss/deepsupervision.py:40-53`):
    halving per scale, the lowest scale zeroed, normalized to sum 1."""
    w = torch.tensor([1.0 / (2**i) for i in range(n_outputs)], dtype=torch.float32)
    if n_outputs > 1:
        w[-1] = 0.0
    return w / torch.sum(w)


def deep_supervision_loss(
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    outputs: Sequence[torch.Tensor],
    labels: Sequence[torch.Tensor],
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`DeepSupervisionWrapper` (`loss/deepsupervision.py:5-36`)."""
    if weights is None:
        weights = deep_supervision_weights(len(outputs))
    total = 0.0
    for w, o, l in zip(weights.tolist(), outputs, labels):
        total = total + w * loss_fn(o, l)
    return total
