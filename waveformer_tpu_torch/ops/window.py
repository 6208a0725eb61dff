"""3D window partition and the reference's flat window merge.

Port of `waveformer_tpu/ops/window.py`, channels-last layout.
"""

from __future__ import annotations

from typing import Tuple

import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, D, H, W, C) → (B·nW, window_size³, C)."""
    b, d, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, d // ws, ws, h // ws, ws, w // ws, ws, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, ws * ws * ws, c)


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
