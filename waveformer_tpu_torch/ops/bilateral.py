"""Bilateral filters on channels-last volumes, as shifted adds.

Port of `waveformer_tpu/ops/bilateral.py` (the JAX package's answer to
MONAI's `filtering/bilateral` and `trainable_bilateral` extensions): a
truncated-window bilateral sum over every offset with |o|∞ ≤ radius, each
offset one zero-filled shift of the volume and a few elementwise ops on its
device. Neighbours shifted in from outside the volume are zeros that still
add their weight to the denominator, which is floored at 1e-8. Everything
is differentiable by autograd in x and in tensor sigmas.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

Sigma = Union[float, torch.Tensor]


def _shift(x: torch.Tensor, offset: Sequence[int]) -> torch.Tensor:
    """out[p] = x[p − o] along the spatial axes 1..3, zeros where p − o
    falls outside (a roll whose wrapped part is zeroed)."""
    if not any(offset):
        return x
    out = torch.zeros_like(x)
    dst = [slice(None)] * x.ndim
    src = [slice(None)] * x.ndim
    for ax, o in enumerate(offset, start=1):
        n = x.shape[ax]
        dst[ax] = slice(max(o, 0), n + min(o, 0))
        src[ax] = slice(max(-o, 0), n - max(o, 0))
    out[tuple(dst)] = x[tuple(src)]
    return out


def _offsets(radius: int):
    return list(itertools.product(range(-radius, radius + 1), repeat=3))


def bilateral_filter(x: torch.Tensor, spatial_sigma: Sigma = 1.0, color_sigma: Sigma = 0.5,
                     truncate: float = 2.0, radius: Optional[int] = None) -> torch.Tensor:
    """Bilateral filter of channels-last x (B, D, H, W, C).

    y[p] = Σ_o G_s(o)·G_r(x[p+o] − x[p])·x[p+o] / Σ_o G_s(o)·G_r(...), per
    channel, over |o|∞ ≤ radius (default max(ceil(truncate·σs), 1)). A
    tensor `spatial_sigma` needs an explicit `radius`: the window's extent
    is fixed before the sigma's value is read."""
    if radius is None:
        if not isinstance(spatial_sigma, (int, float)):
            raise ValueError(
                "pass an explicit `radius` when spatial_sigma is a tensor: the "
                "window's extent must not depend on its value"
            )
        radius = max(int(math.ceil(truncate * spatial_sigma)), 1)
    ss2 = _two_sigma_sq(spatial_sigma, x.device)
    cs2 = _two_sigma_sq(color_sigma, x.device)

    x32 = x.float()
    num = torch.zeros_like(x32)
    den = torch.zeros_like(x32)
    for off in _offsets(radius):
        d2 = float(sum(o * o for o in off))
        if torch.is_tensor(ss2):
            ws = torch.exp(-d2 / ss2)
        else:
            ws = float(np.exp(np.float32(-d2) / np.float32(ss2)))
        xo = _shift(x32, off)
        # range distance per channel
        wr = torch.exp(-((xo - x32) ** 2) / cs2)
        w = ws * wr
        num = num + w * xo
        den = den + w
    return (num / den.clamp_min(1e-8)).to(x.dtype)


def _two_sigma_sq(sigma: Sigma, device):
    """2σ² rounded as the JAX op makes it from an fp32 array: a tensor on
    `device` for a tensor sigma, else a float (an fp32 value), so that a
    number's weights need no tensor made from the host."""
    if torch.is_tensor(sigma):
        return 2.0 * sigma.to(device=device, dtype=torch.float32) ** 2
    s = np.float32(sigma)
    return float(np.float32(2.0) * (s * s))


class TrainableBilateralFilter(nn.Module):
    """Bilateral filter with learnable sigmas (the capability of MONAI's
    `trainable_bilateral`): two scalar fp32 parameters, each clamped at
    1e-3 when used; the radius is fixed at construction from the initial
    spatial sigma."""

    def __init__(self, spatial_sigma: float = 1.0, color_sigma: float = 0.5,
                 truncate: float = 2.0):
        super().__init__()
        self.radius = max(int(math.ceil(truncate * spatial_sigma)), 1)
        self.spatial_sigma = nn.Parameter(torch.tensor(spatial_sigma, dtype=torch.float32))
        self.color_sigma = nn.Parameter(torch.tensor(color_sigma, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bilateral_filter(
            x,
            spatial_sigma=self.spatial_sigma.clamp_min(1e-3),
            color_sigma=self.color_sigma.clamp_min(1e-3),
            radius=self.radius,
        )


def joint_bilateral_filter(x: torch.Tensor, guide: torch.Tensor, spatial_sigma: float = 1.0,
                           color_sigma: float = 0.5, truncate: float = 2.0) -> torch.Tensor:
    """Joint (cross) bilateral filter: the range weights come from `guide`
    (B, D, H, W, Cg), its squared distance summed over the guide's channels,
    and weigh every channel of x alike."""
    radius = max(int(math.ceil(truncate * spatial_sigma)), 1)
    ss2 = 2.0 * spatial_sigma ** 2
    cs2 = 2.0 * color_sigma ** 2
    x32 = x.float()
    g32 = guide.float()
    num = torch.zeros_like(x32)
    den = torch.zeros_like(x32)
    for off in _offsets(radius):
        d2 = float(sum(o * o for o in off))
        ws = math.exp(-d2 / ss2)
        xo = _shift(x32, off)
        go = _shift(g32, off)
        wr = torch.exp(-((go - g32) ** 2).sum(dim=-1, keepdim=True) / cs2)
        w = ws * wr
        num = num + w * xo
        den = den + w
    return (num / den.clamp_min(1e-8)).to(x.dtype)
