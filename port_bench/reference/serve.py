"""Plain full-volume inference: MONAI's Gaussian sliding window with the
nnUNet mirror TTA of the published `4_predict.py`, written for the
benchmark.

A volume (C, D, H, W) is zero-padded at its far end to the bucket shape
(each axis at least the ROI, then a whole number of scan intervals past
it), split into MONAI's dense patch grid (stride int(roi · (1 − overlap)),
the last patch flush with the end), and each patch's logits are weighted
by the Gaussian importance map (σ = roi / 8, floored at max(min, 1e-3)),
summed and divided by the summed weights. TTA runs the whole window once
per subset of the mirror axes on the flipped volume and averages the
flipped-back results. The logits are then cropped to the volume.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch


def scan_interval(roi: Sequence[int], overlap: float) -> Tuple[int, ...]:
    return tuple(max(int(r * (1.0 - overlap)), 1) if r > 1 else 1 for r in roi)


def bucket(spatial: Sequence[int], roi: Sequence[int], overlap: float) -> Tuple[int, ...]:
    out = []
    for n, r, s in zip(spatial, roi, scan_interval(roi, overlap)):
        n = max(n, r)
        out.append(r + int(math.ceil((n - r) / s)) * s)
    return tuple(out)


def patch_starts(spatial: Sequence[int], roi: Sequence[int], overlap: float):
    per_axis = []
    for n, r, s in zip(spatial, roi, scan_interval(roi, overlap)):
        if n <= r:
            per_axis.append([0])
            continue
        count = next(k for k in range(int(math.ceil(n / s)) + 1) if k * s + r >= n) + 1
        per_axis.append([min(k * s, n - r) for k in range(count)])
    return list(itertools.product(*per_axis))


@functools.lru_cache(maxsize=None)
def gaussian(roi: Tuple[int, ...], sigma_scale: float = 0.125) -> np.ndarray:
    maps = []
    for n in roi:
        x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
        maps.append(np.exp(-(x ** 2) / (2 * (sigma_scale * n) ** 2)))
    m = functools.reduce(np.multiply.outer, maps)
    return np.clip(m, max(m.min(), 1e-3), None).astype(np.float32)


def orientations(mirror_axes: Sequence[int]):
    """Every subset of the mirror axes, the empty one first."""
    return [c for r in range(len(mirror_axes) + 1)
            for c in itertools.combinations(tuple(mirror_axes), r)]


def predict_logits(model: Callable[[torch.Tensor], torch.Tensor], volume: torch.Tensor,
                   out_channels: int, roi: Sequence[int], overlap: float, batch: int,
                   mirror_axes: Sequence[int] = ()) -> torch.Tensor:
    """(C, D, H, W) float32 volume → (out_channels, D, H, W) float32 logits.
    `model` maps channels-last patches (B, *roi, C) to logits (B, *roi, K);
    `batch` patches go through it at a time."""
    roi = tuple(int(r) for r in roi)
    spatial = tuple(volume.shape[1:])
    padded = bucket(spatial, roi, overlap)
    pad = []
    for p, s in zip(reversed(padded), reversed(spatial)):
        pad += [0, p - s]
    vol = torch.nn.functional.pad(volume, pad)
    starts = patch_starts(padded, roi, overlap)
    imp = torch.from_numpy(gaussian(roi)).to(vol.device)
    weight = torch.zeros(padded, device=vol.device)
    for s in starts:
        weight[tuple(slice(a, a + r) for a, r in zip(s, roi))] += imp
    total = torch.zeros((out_channels, *padded), device=vol.device)
    for axes in orientations(mirror_axes):
        dims = tuple(a + 1 for a in axes)
        v = torch.flip(vol, dims) if axes else vol
        acc = torch.zeros_like(total)
        for i in range(0, len(starts), batch):
            chunk = starts[i:i + batch]
            views = [tuple(slice(a, a + r) for a, r in zip(s, roi)) for s in chunk]
            x = torch.stack([v[(slice(None),) + sl] for sl in views]).permute(0, 2, 3, 4, 1)
            y = model(x).permute(0, 4, 1, 2, 3).float() * imp
            for sl, yi in zip(views, y):
                acc[(slice(None),) + sl] += yi
        acc /= weight
        total += torch.flip(acc, dims) if axes else acc
    total /= len(orientations(mirror_axes))
    return total[(slice(None),) + tuple(slice(0, s) for s in spatial)]


def widest_gap(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """How far the served label's logit lies below the best one, at the
    voxel where that is widest. `logits` (K, D, H, W), `labels` (D, H, W)."""
    served = logits.gather(0, labels.long().unsqueeze(0))[0]
    return float((logits.max(dim=0).values - served).max())
