"""Sliding-window inference with Gaussian blending and mirror TTA.

Port of `waveformer_tpu/inference/sliding_window.py` (MONAI
`sliding_window_inference` semantics, reference TTA of
`light_training/prediction.py:110-160`), in both of its layouts:
channels-last (D, H, W, C) volumes, the default as in JAX, and
channels-first (C, D, H, W). The patch grid, the Gaussian
importance map and the count map are numpy, computed on the host (copies
of the JAX package's helpers). The stitch runs on the volume's device: a
Python loop over chunks of `sw_batch_size` patches, an fp32 accumulator,
and one divide by the count map at the end.

With `tta_mode="patch"` and a mirror-symmetric grid (every bucketed
shape), volume-level TTA equals averaging the flipped predictions per
patch, so the volume is sliced and stitched once; otherwise each
orientation is a full sliding-window pass over the flipped volume.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def compute_importance_map(
    patch_size: Tuple[int, ...],
    mode: str = "gaussian",
    sigma_scale: float = 0.125,
) -> np.ndarray:
    """MONAI-parity importance map (`monai/data/utils.py:1088-1139`)."""
    if mode == "constant":
        return np.ones(patch_size, dtype=np.float32)
    if mode != "gaussian":
        raise ValueError(f"unsupported blend mode {mode!r}")
    maps = []
    for n in patch_size:
        sigma = sigma_scale * n
        x = np.arange(-(n - 1) / 2.0, (n - 1) / 2.0 + 1, dtype=np.float64)
        maps.append(np.exp(-(x**2) / (2 * sigma**2)))
    m = functools.reduce(np.multiply.outer, maps)
    min_non_zero = max(m.min(), 1e-3)
    return np.clip(m, min_non_zero, None).astype(np.float32)


def scan_interval(roi_size: Sequence[int], overlap: float) -> Tuple[int, ...]:
    """MONAI `_get_scan_interval`: int(roi · (1 − overlap)) per dim."""
    return tuple(
        max(int(r * (1.0 - overlap)), 1) if r > 1 else 1 for r in roi_size
    )


def dense_patch_starts(
    image_size: Sequence[int], roi_size: Sequence[int], overlap: float
) -> np.ndarray:
    """(N, 3) int32 patch start corners (MONAI `dense_patch_slices`): stride
    = interval, the last patch shifted flush with the volume end."""
    interval = scan_interval(roi_size, overlap)
    per_dim = []
    for L, r, s in zip(image_size, roi_size, interval):
        if L <= r:
            per_dim.append([0])
            continue
        n = next(d for d in range(int(math.ceil(L / s)) + 1) if d * s + r >= L) + 1
        starts = []
        for i in range(n):
            st = i * s
            st -= max(st + r - L, 0)
            starts.append(st)
        per_dim.append(starts)
    grid = np.meshgrid(*per_dim, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1).astype(np.int32)


def bucket_shape(
    image_size: Sequence[int], roi_size: Sequence[int], overlap: float
) -> Tuple[int, ...]:
    """Spatial dims rounded up to at least `roi`, then to a multiple of the
    scan interval (one patch grid serves many case shapes)."""
    interval = scan_interval(roi_size, overlap)
    out = []
    for L, r, s in zip(image_size, roi_size, interval):
        L = max(L, r)
        out.append(r + int(math.ceil((L - r) / s)) * s)
    return tuple(out)


def count_map(
    image_size: Sequence[int],
    roi_size: Sequence[int],
    overlap: float,
    mode: str = "gaussian",
) -> np.ndarray:
    """Σ importance weights per voxel (input-independent)."""
    imp = compute_importance_map(tuple(roi_size), mode)
    starts = dense_patch_starts(image_size, roi_size, overlap)
    cm = np.zeros(tuple(image_size), dtype=np.float32)
    for s in starts:
        sl = tuple(slice(int(a), int(a) + r) for a, r in zip(s, roi_size))
        cm[sl] += imp
    return cm


def _flip_axes_combinations(mirror_axes: Sequence[int]):
    """All subsets of the mirror axes, the empty one first: the
    reference's 8 TTA passes (`light_training/prediction.py:127-158`)."""
    combos = [()]
    for r in range(1, len(mirror_axes) + 1):
        combos.extend(itertools.combinations(mirror_axes, r))
    return combos


def _grid_symmetric(starts: np.ndarray, spatial, roi_size) -> bool:
    for dim, (L, r) in enumerate(zip(spatial, roi_size)):
        ax_starts = np.unique(starts[:, dim])
        if not np.array_equal(np.sort(ax_starts), np.sort(L - r - ax_starts)):
            return False
    return True


def sliding_window_inference(
    volume: torch.Tensor,
    predictor: Callable[[torch.Tensor], torch.Tensor],
    roi_size: Tuple[int, int, int],
    out_channels: int,
    overlap: float = 0.5,
    sw_batch_size: int = 2,
    mode: str = "gaussian",
    mirror_axes: Optional[Sequence[int]] = None,
    tta_mode: str = "volume",
    maps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    layout: str = "channels_last",
) -> torch.Tensor:
    """Blend `predictor` over dense patches of one volume.

    volume: (D, H, W, C), spatial dims already bucket-padded.
    predictor: (B, *roi, C) → (B, *roi, out_channels) logits.
    Returns (D, H, W, out_channels) fp32 logits, TTA-averaged if mirrored.
    With `layout="channels_first"` all three are channels-first instead:
    (C, D, H, W), (B, C, *roi) → (B, out_channels, *roi) and
    (out_channels, D, H, W).
    `maps` may carry the (importance, count) maps already on the device.
    """
    cf = _channels_first(layout)
    roi_size = tuple(int(r) for r in roi_size)
    spatial = tuple(volume.shape[1:] if cf else volume.shape[:3])
    starts = dense_patch_starts(spatial, roi_size, overlap)
    n_patches = len(starts)
    if maps is None:
        maps = (
            torch.from_numpy(compute_importance_map(roi_size, mode)).to(volume.device),
            torch.from_numpy(count_map(spatial, roi_size, overlap, mode)).to(volume.device),
        )
    imp, cm = maps
    if not cf:  # weights broadcast over the trailing channel axis
        imp, cm = imp[..., None], cm[..., None]
    # first spatial axis of a volume and of a batch of patches
    vol_ax, patch_ax = (1, 2) if cf else (0, 1)
    # the last chunk is filled with repeats of the final patch, whose
    # outputs are dropped: every predictor call sees the same batch size
    pad_to = int(math.ceil(n_patches / sw_batch_size)) * sw_batch_size
    sts = [tuple(int(v) for v in s) for s in starts]
    sts += [sts[-1]] * (pad_to - n_patches)

    def slices(s):
        sp = tuple(slice(a, a + r) for a, r in zip(s, roi_size))
        return (slice(None),) + sp if cf else sp

    def run_one_orientation(vol: torch.Tensor, pred_fn) -> torch.Tensor:
        shape = (out_channels, *spatial) if cf else (*spatial, out_channels)
        acc = torch.zeros(shape, dtype=torch.float32, device=vol.device)
        for i0 in range(0, pad_to, sw_batch_size):
            chunk = sts[i0 : i0 + sw_batch_size]
            patches = torch.stack([vol[slices(s)] for s in chunk], dim=0)
            logits = pred_fn(patches).float() * imp
            for i, s in enumerate(chunk):
                if i0 + i < n_patches:
                    acc[slices(s)] += logits[i]
        return acc

    if not mirror_axes:
        return run_one_orientation(volume, predictor) / cm

    combos = _flip_axes_combinations(tuple(mirror_axes))
    if tta_mode == "patch" and _grid_symmetric(starts, spatial, roi_size):

        def tta_predictor(patches: torch.Tensor) -> torch.Tensor:
            total = None
            for axes in combos:
                dims = tuple(a + patch_ax for a in axes)
                p = torch.flip(patches, dims) if axes else patches
                part = predictor(p).float()
                part = torch.flip(part, dims) if axes else part
                total = part if total is None else total + part
            return total / len(combos)

        return run_one_orientation(volume, tta_predictor) / cm

    total = None
    for axes in combos:
        dims = tuple(a + vol_ax for a in axes)
        v = torch.flip(volume, dims) if axes else volume
        pred = run_one_orientation(v, predictor) / cm
        pred = torch.flip(pred, dims) if axes else pred
        total = pred if total is None else total + pred
    return total / len(combos)


def _channels_first(layout: str) -> bool:
    if layout not in ("channels_last", "channels_first"):
        raise ValueError(f"unknown layout {layout!r}")
    return layout == "channels_first"


class SlidingWindowInferer:
    """Configured sliding-window inference (MONAI `SlidingWindowInferer`):
    pads a volume to the bucket shape, runs `sliding_window_inference`
    without autograd, crops back. Volumes are (D, H, W, C) by default, as in
    the JAX package, or (C, D, H, W) with `layout="channels_first"`."""

    def __init__(
        self,
        roi_size: Tuple[int, int, int],
        sw_batch_size: int = 2,
        overlap: float = 0.5,
        mode: str = "gaussian",
        mirror_axes: Optional[Sequence[int]] = None,
        tta_mode: str = "volume",
        layout: str = "channels_last",
    ):
        _channels_first(layout)
        if tta_mode not in ("volume", "patch"):
            raise ValueError(f"unknown tta_mode {tta_mode!r}")
        self.roi_size = tuple(int(r) for r in roi_size)
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self.mode = mode
        self.mirror_axes = tuple(mirror_axes) if mirror_axes else None
        self.tta_mode = tta_mode
        self.layout = layout
        self._maps: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def padded_shape(self, spatial: Sequence[int]) -> Tuple[int, ...]:
        return bucket_shape(spatial, self.roi_size, self.overlap)

    def _device_maps(self, padded, device) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (tuple(padded), str(device))
        if key not in self._maps:
            imp = compute_importance_map(self.roi_size, self.mode)
            cm = count_map(padded, self.roi_size, self.overlap, self.mode)
            self._maps[key] = (
                torch.from_numpy(imp).to(device),
                torch.from_numpy(cm).to(device),
            )
        return self._maps[key]

    def __call__(
        self,
        volume: torch.Tensor,
        predictor: Callable[[torch.Tensor], torch.Tensor],
        out_channels: int,
    ) -> torch.Tensor:
        """volume (D, H, W, C) → fp32 logits (D, H, W, out_channels), or
        (C, D, H, W) → (out_channels, D, H, W) channels-first, at the
        volume's own shape, on its device."""
        cf = _channels_first(self.layout)
        volume = torch.as_tensor(volume)
        spatial = tuple(volume.shape[1:] if cf else volume.shape[:3])
        padded = self.padded_shape(spatial)
        with torch.inference_mode():
            pads = [] if cf else [0, 0]  # F.pad lists the last axis first
            for p, s in zip(reversed(padded), reversed(spatial)):
                pads += [0, p - s]
            vol = F.pad(volume, pads) if any(pads) else volume
            logits = sliding_window_inference(
                vol,
                predictor,
                roi_size=self.roi_size,
                out_channels=out_channels,
                overlap=self.overlap,
                sw_batch_size=self.sw_batch_size,
                mode=self.mode,
                mirror_axes=self.mirror_axes,
                tta_mode=self.tta_mode,
                maps=self._device_maps(padded, vol.device),
                layout=self.layout,
            )
            crop = tuple(slice(0, s) for s in spatial)
            return logits[(slice(None),) + crop] if cf else logits[crop]
