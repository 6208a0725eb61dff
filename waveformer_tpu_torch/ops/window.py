"""3D window partition, its inverse and the reference's flat window merge;
Swin's padding to whole windows, cyclic shift and shift regions.

Port of `waveformer_tpu/ops/window.py`, channels-last layout; the Swin
pieces follow MONAI's `SwinTransformerBlock` and `compute_mask`. A window
is an int (a cube) or a (d, h, w) tuple.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Window = Union[int, Sequence[int]]


def _ws3(window_size: Window) -> Tuple[int, int, int]:
    if isinstance(window_size, int):
        return (window_size,) * 3
    return tuple(int(w) for w in window_size)


def window_partition(x: torch.Tensor, window_size: Window) -> torch.Tensor:
    """(B, D, H, W, C) → (B·nW, wd·wh·ww, C)."""
    b, d, h, w, c = x.shape
    wd, wh, ww = _ws3(window_size)
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_unpartition(
    windows: torch.Tensor, window_size: Window, grid: Tuple[int, int, int]
) -> torch.Tensor:
    """(B·nW, wd·wh·ww, C) → (B, D, H, W, C): the true inverse of
    `window_partition`."""
    d, h, w = grid
    wd, wh, ww = _ws3(window_size)
    c = windows.shape[-1]
    b = windows.shape[0] // ((d // wd) * (h // wh) * (w // ww))
    x = windows.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, c)


def window_unpartition_flat(
    windows: torch.Tensor, window_size: int, grid: Tuple[int, int, int]
) -> torch.Tensor:
    """Reference-compatible merge (`wave_helper.py:498-499`): a row-major
    reshape of (B·nW, ws³, C) straight into (B, D, H, W, C). It is not the
    inverse of `window_partition` when nW > 1; released checkpoints were
    trained with exactly this mapping, so it is kept."""
    d, h, w = grid
    ws = window_size
    c = windows.shape[-1]
    n_windows = (d // ws) * (h // ws) * (w // ws)
    b = windows.shape[0] // n_windows
    return windows.reshape(b, d, h, w, c)


def padded_grid(grid: Sequence[int], window_size: Window) -> Tuple[int, int, int]:
    """Each axis of `grid` rounded up to a whole number of windows."""
    return tuple(-(-g // w) * w for g, w in zip(grid, _ws3(window_size)))


def pad_to_windows(x: torch.Tensor, window_size: Window) -> torch.Tensor:
    """Zeros at the far end of each spatial axis of (B, D, H, W, C) up to
    `padded_grid` (MONAI pads after `norm1`, and does not mask the zeros)."""
    grid = x.shape[1:4]
    pd, ph, pw = (p - g for p, g in zip(padded_grid(grid, window_size), grid))
    if pd == ph == pw == 0:
        return x
    return F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))


def cyclic_shift(x: torch.Tensor, shift: Sequence[int]) -> torch.Tensor:
    """`torch.roll` of (B, D, H, W, C)'s spatial axes by `shift` (Swin rolls
    by −s before attending and by +s after)."""
    return torch.roll(x, shifts=tuple(int(s) for s in shift), dims=(1, 2, 3))


def shift_labels(grid: Tuple[int, int, int], window_size: Tuple[int, int, int],
                 shift: Tuple[int, int, int]) -> torch.Tensor:
    """MONAI's `compute_mask` regions over a padded `grid`: each axis split
    at −window and −shift into three slices, the 27 boxes numbered 0-26 in
    d, h, w order, then partitioned into windows: (nW, N) uint8. Two tokens
    of a window are masked from each other where their labels differ."""
    img = torch.zeros(grid, dtype=torch.uint8)
    cnt = 0
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(window_size, shift)]
    for d in cuts[0]:
        for h in cuts[1]:
            for w in cuts[2]:
                img[d, h, w] = cnt
                cnt += 1
    return window_partition(img[None, ..., None], window_size)[..., 0]
