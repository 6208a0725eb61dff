"""Trilinear resize of the three spatial axes, in both corner modes.

Port of `waveformer_tpu/ops/resize.py`: the JAX op replicates
`F.interpolate(mode="trilinear")`, so the port calls it. `align_corners`
is chosen per call site (False when fusing attention scales and resampling
logits, True inside `ProjectionUpsample`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def resize_trilinear(
    x: torch.Tensor,
    out_size: Sequence[int],
    align_corners: bool = False,
    axes: Tuple[int, int, int] = (1, 2, 3),
) -> torch.Tensor:
    """Resize spatial `axes` of a 5-D tensor to `out_size`.

    The default axes are the channels-last (B, D, H, W, C) layout; pass
    `axes=(2, 3, 4)` for NCDHW. The result has the input's layout and
    dtype."""
    out_size = tuple(int(s) for s in out_size)
    if tuple(x.shape[a] for a in axes) == out_size:
        return x
    if tuple(axes) == (1, 2, 3):
        xc = x.permute(0, 4, 1, 2, 3)
    elif tuple(axes) == (2, 3, 4):
        xc = x
    else:
        raise ValueError(f"unsupported spatial axes {axes}")
    y = F.interpolate(
        xc, size=out_size, mode="trilinear", align_corners=align_corners
    )
    return y.permute(0, 2, 3, 4, 1) if tuple(axes) == (1, 2, 3) else y
