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
in fp32 whatever the logits' dtype. Where JAX takes `axis_name` (a psum of
the batch-dice statistics over the mesh's data axis), the port takes
`group`, a `torch.distributed` process group: with `batch_dice` the
statistics are summed over the ranks of `group` by a differentiable
all-reduce (`parallel.collectives.cross_replica_sum`), the global batch
dice of nnUNet's DDP `SoftDiceLoss` (`light_training/loss/dice.py:36-48`).
Every rank then holds the same dice term, and the data-parallel step's
mean over ranks of the gradients is that term's gradient (see
`parallel/collectives.py`).

Where JAX's GSPMD splits a volume's D over the mesh's `spatial` axis, the
port's losses take `spatial`, this rank's line of it (an `AxisShard`), and
logits and labels are this rank's D slab: every sum over the volume (the
Dice statistics, the CE and BCE voxel sums) is summed over the line by
`AxisShard.reduce`, whose backward passes the cotangent on, since every
rank of the line computes the same loss from the sums; `topk_cross_entropy`
gathers the per-voxel CE along D the same way before its top-k. The loss
is then the whole volume's on every rank of the line.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from waveformer_tpu_torch.parallel import spatial as depth
from waveformer_tpu_torch.parallel.collectives import AxisShard, cross_replica_sum


def _volume_sum(x: torch.Tensor, spatial: Optional[AxisShard]) -> torch.Tensor:
    """x, sums over this rank's slab, summed over the spatial line."""
    return x if spatial is None else spatial.reduce(x.contiguous())


def _voxels(x: torch.Tensor, spatial: Optional[AxisShard]) -> int:
    """Elements of x over the whole volume."""
    return x.numel() * (1 if spatial is None else spatial.size)


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """fp32 one-hot over a trailing class axis; a label outside
    [0, num_classes) gives a zero row, as `jax.nn.one_hot` does."""
    if labels.shape[-1] == 1:
        labels = labels[..., 0]
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long()[..., None] == classes).float()


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, weight: Optional[torch.Tensor] = None,
    spatial: Optional[AxisShard] = None,
) -> torch.Tensor:
    """Mean CE over all voxels (torch `nn.CrossEntropyLoss` semantics)."""
    onehot = _one_hot(labels, logits.shape[-1])
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -(onehot * logp)
    if weight is not None:
        ce = ce * weight.float()
    ce = torch.sum(ce, dim=-1)
    if spatial is None:
        return torch.mean(ce)
    return _volume_sum(torch.sum(ce), spatial) / _voxels(ce, spatial)


def soft_dice_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    include_background: bool = True,
    squared_pred: bool = False,
    smooth_nr: float = 1e-5,
    smooth_dr: float = 1e-5,
    batch_dice: bool = False,
    group: Optional[dist.ProcessGroup] = None,
    apply_softmax: bool = True,
    spatial: Optional[AxisShard] = None,
) -> torch.Tensor:
    """MONAI `DiceLoss(softmax=True, to_onehot_y=True)` semantics
    (`monai/losses/dice.py:30-200`): per-(sample, class) dice over spatial
    dims, mean-reduced; with `batch_dice` the statistics are summed over
    the batch first, and over the ranks of `group` if one is given."""
    num_classes = logits.shape[-1]
    probs = F.softmax(logits.float(), dim=-1) if apply_softmax else logits.float()
    onehot = _one_hot(labels, num_classes)
    dims = tuple(range(1, logits.ndim - 1))

    intersection = torch.sum(probs * onehot, dim=dims)  # (B, K)
    if squared_pred:
        pred_sum = torch.sum(probs**2, dim=dims)
        gt_sum = torch.sum(onehot**2, dim=dims)
    else:
        pred_sum = torch.sum(probs, dim=dims)
        gt_sum = torch.sum(onehot, dim=dims)
    if spatial is not None:
        intersection, pred_sum, gt_sum = _volume_sum(
            torch.stack([intersection, pred_sum, gt_sum]), spatial)

    if batch_dice:
        intersection = torch.sum(intersection, dim=0, keepdim=True)
        pred_sum = torch.sum(pred_sum, dim=0, keepdim=True)
        gt_sum = torch.sum(gt_sum, dim=0, keepdim=True)
        if group is not None:
            intersection, pred_sum, gt_sum = cross_replica_sum(
                torch.stack([intersection, pred_sum, gt_sum]), group)

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
    group: Optional[dist.ProcessGroup] = None,
    spatial: Optional[AxisShard] = None,
) -> torch.Tensor:
    """MONAI `DiceCELoss(to_onehot_y=True, softmax=True)` (`dice.py:639`);
    the CE term is this rank's mean."""
    d = soft_dice_loss(logits, labels, include_background=include_background,
                       batch_dice=batch_dice, group=group, spatial=spatial)
    c = softmax_cross_entropy(logits, labels, spatial=spatial)
    return lambda_dice * d + lambda_ce * c


class DiceCELoss:
    """Callable config wrapper mirroring the reference's loss object."""

    def __init__(self, lambda_dice=1.0, lambda_ce=1.0, include_background=True,
                 batch_dice=False, group=None):
        self.kwargs = dict(lambda_dice=lambda_dice, lambda_ce=lambda_ce,
                           include_background=include_background, batch_dice=batch_dice,
                           group=group)

    def __call__(self, logits, labels, spatial=None):
        return dice_ce_loss(logits, labels, spatial=spatial, **self.kwargs)


def dice_bce_loss(
    logits: torch.Tensor,
    region_targets: torch.Tensor,
    weight_ce: float = 1.0,
    weight_dice: float = 1.0,
    use_ignore_label: bool = False,
    batch_dice: bool = True,
    smooth: float = 1e-5,
    group: Optional[dist.ProcessGroup] = None,
    spatial: Optional[AxisShard] = None,
) -> torch.Tensor:
    """Region-based sigmoid DC+BCE (reference `DC_and_BCE_loss`,
    `light_training/loss/compound_losses.py:60-100` with
    `MemoryEfficientSoftDiceLoss`, `loss/dice.py:58-115`).

    `region_targets` is one-hot over overlapping regions, channels-last
    (B, *spatial, K); with `use_ignore_label` the last channel marks voxels
    to exclude. The dice term is `-mean(dice)`, so the loss can be
    negative; `batch_dice` sums the statistics over the batch, and over
    the ranks of `group` if one is given (the BCE term is this rank's
    mean)."""
    x = logits.float()
    t = region_targets.float()
    mask = None
    if use_ignore_label:
        mask = 1.0 - t[..., -1:]
        t = t[..., :-1]

    # BCE with logits (torch BCEWithLogitsLoss semantics), written out
    bce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    if mask is not None:
        if spatial is None:
            ce = torch.sum(bce * mask) / torch.clamp(torch.sum(mask), min=1e-8)
        else:
            num, den = _volume_sum(torch.stack([torch.sum(bce * mask), torch.sum(mask)]),
                                   spatial)
            ce = num / torch.clamp(den, min=1e-8)
    elif spatial is None:
        ce = torch.mean(bce)
    else:
        ce = _volume_sum(torch.sum(bce), spatial) / _voxels(bce, spatial)

    probs = torch.sigmoid(x)
    dims = tuple(range(1, x.ndim - 1))
    if mask is not None:
        intersect = torch.sum(probs * t * mask, dim=dims)
        sum_pred = torch.sum(probs * mask, dim=dims)
        sum_gt = torch.sum(t * mask, dim=dims)
    else:
        intersect = torch.sum(probs * t, dim=dims)
        sum_pred = torch.sum(probs, dim=dims)
        sum_gt = torch.sum(t, dim=dims)
    if spatial is not None:
        intersect, sum_pred, sum_gt = _volume_sum(
            torch.stack([intersect, sum_pred, sum_gt]), spatial)
    if batch_dice:
        intersect = torch.sum(intersect, dim=0)
        sum_pred = torch.sum(sum_pred, dim=0)
        sum_gt = torch.sum(sum_gt, dim=0)
        if group is not None:
            intersect, sum_pred, sum_gt = cross_replica_sum(
                torch.stack([intersect, sum_pred, sum_gt]), group)
    dc = (2.0 * intersect + smooth) / torch.clamp(sum_gt + sum_pred + smooth, min=1e-8)
    return weight_ce * ce - weight_dice * torch.mean(dc)


def topk_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, k_percent: float = 10.0,
    spatial: Optional[AxisShard] = None,
) -> torch.Tensor:
    """nnUNet `TopKLoss` (`loss/robust_ce_loss.py`): mean over the top-k%
    highest-CE voxels of each sample (of the whole volume: with `spatial`
    the per-voxel CE is gathered along D first)."""
    onehot = _one_hot(labels, logits.shape[-1])
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -torch.sum(onehot * logp, dim=-1)
    ce = depth.gather_depth(ce.contiguous(), spatial, replicated=True)
    ce = ce.reshape(logits.shape[0], -1)
    k = max(1, int(ce.shape[1] * k_percent / 100.0))
    return torch.mean(torch.topk(ce, k, dim=1).values)


def dice_topk_loss(logits, labels, k_percent=10.0, spatial=None, **dice_kwargs):
    """nnUNet `DC_and_topk_loss` (`loss/compound_losses.py:103`)."""
    return soft_dice_loss(logits, labels, spatial=spatial, **dice_kwargs) + topk_cross_entropy(
        logits, labels, k_percent, spatial=spatial
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
