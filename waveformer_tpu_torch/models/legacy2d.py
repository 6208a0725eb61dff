"""2D token-sequence modules kept for the reference's surface.

Port of `waveformer_tpu/models/legacy2d.py`: the PVT/SegFormer helpers that
the reference defines and no 3D WaveFormer path builds (its
`wave_helper.py` `Mlp`, `DWConv`, `OverlapPatchEmbed`, `PosCNN`). Token
sequences are (B, N, C) with N = H·W; images are channels-last (B, H, W, C)
as in the JAX modules. Submodule names are the JAX modules' (`fc1`, `fc2`,
`dwconv`, `proj`, `norm`, `proj_dw`, `proj_pw`), so
`utils/jax_params.legacy2d_state_dict_from_jax` carries their weights.

Initialisation follows the JAX modules, drawn from `generator` when one is
given: Linear weights trunc-normal(0.02) cut at ±2σ, conv weights
normal(0, √(2 / fan_out)) with fan_out = kh·kw·out, biases zero, LayerNorm
unit. GELU is the exact erf form (the JAX modules' is a polynomial within
1.5e-7 of it). Dropout follows `train()` / `eval()`; JAX's default
`deterministic=True` is `eval()`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from waveformer_tpu_torch.models.common import gelu


def _tokens_to_image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, N, C) → (B, C, H, W) with N == H·W."""
    b, n, c = x.shape
    if n != h * w:
        raise ValueError(f"token count {n} != H*W = {h}*{w}")
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _image_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W, C)."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _init_dense(m: nn.Linear, generator: Optional[torch.Generator]) -> nn.Linear:
    nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
    nn.init.zeros_(m.bias)
    return m


def _init_conv(m: nn.Conv2d, generator: Optional[torch.Generator]) -> nn.Conv2d:
    fan_out = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
    nn.init.normal_(m.weight, 0.0, math.sqrt(2.0 / fan_out), generator=generator)
    nn.init.zeros_(m.bias)
    return m


class Mlp2D(nn.Module):
    """Token MLP: fc1 → GELU → dropout → fc2 → dropout (reference `Mlp`)."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.fc1 = _init_dense(nn.Linear(in_features, hidden), generator)
        self.fc2 = _init_dense(nn.Linear(hidden, out), generator)
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.drop(gelu(self.fc1(x)))
        return self.drop(self.fc2(h))


class DWConv2D(nn.Module):
    """Depthwise 3×3 conv over a token sequence on its (H, W) grid
    (reference `DWConv`): (B, N, C) → (B, N, C)."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dwconv = _init_conv(nn.Conv2d(dim, dim, 3, padding=1, groups=dim), generator)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return _image_to_tokens(self.dwconv(_tokens_to_image(x, h, w)))


class OverlapPatchEmbed2D(nn.Module):
    """Overlapping patch embedding (reference `OverlapPatchEmbed`): conv
    (kernel `patch_size`, `stride`, padding patch_size // 2) of a (B, H, W,
    C) image → tokens → LayerNorm (eps 1e-5). Returns (tokens, H_out,
    W_out)."""

    def __init__(self, in_chans: int, embed_dim: int = 768, patch_size: int = 7,
                 stride: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = _init_conv(nn.Conv2d(in_chans, embed_dim, patch_size, stride=stride,
                                         padding=patch_size // 2), generator)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        img = self.proj(x.permute(0, 3, 1, 2))
        h, w = img.shape[2], img.shape[3]
        return self.norm(_image_to_tokens(img)), h, w


class PosCNN2D(nn.Module):
    """Conditional positional encoding (reference `PosCNN`): depthwise 3×3
    at `stride` → GELU → 1×1 conv, plus the input at stride 1. The
    reference's first conv is grouped by embed_dim, which only exists for
    in_chans == embed_dim: tokens of any other width raise."""

    def __init__(self, embed_dim: int = 768, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim, self.stride = embed_dim, stride
        self.proj_dw = _init_conv(nn.Conv2d(embed_dim, embed_dim, 3, stride=stride, padding=1,
                                            groups=embed_dim), generator)
        self.proj_pw = _init_conv(nn.Conv2d(embed_dim, embed_dim, 1), generator)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        if x.shape[-1] != self.embed_dim:
            raise ValueError(
                f"PosCNN2D requires in_chans == embed_dim (got {x.shape[-1]} != "
                f"{self.embed_dim}); the reference's grouped conv is only constructible "
                "in that case")
        img = _tokens_to_image(x, h, w)
        feat = self.proj_pw(gelu(self.proj_dw(img)))
        if self.stride == 1:
            feat = feat + img
        return _image_to_tokens(feat)

