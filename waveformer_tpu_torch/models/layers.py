"""Transformer-side layers: CCF-FFN, patch merging, learnable upsampling.

Port of `waveformer_tpu/models/layers.py`, channels-last layout. Module
names follow the reference `state_dict` keys.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from waveformer_tpu_torch.models.common import ChannelGroupNorm, ConvCL, gelu
from waveformer_tpu_torch.parallel import spatial, tensor_sharding


class CCF_FFN(nn.Module):
    """Convolutional channel-fusion FFN (reference `wave_helper.py:196-300`):
    pwconv(1³) → LN → GELU → dwconv(3³) → LN → GELU → Linear → +residual.
    The residual is inside the FFN; the block adds a second one. Both
    LayerNorms use eps 1e-5 (torch defaults in the reference). With a
    `tensor_shard` the hidden channels are this rank's slice: `pwconv`
    column-parallel on the input through `AxisShard.copy`, the norms'
    statistics summed over the line, `fc` row-parallel
    (`parallel/tensor_sharding.py`)."""

    tensor_shard = None  # this rank's `tensor` line, set by `shard_model`

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.pwconv = ConvCL(in_features, hidden_features, 1)
        self.norm1 = nn.LayerNorm(hidden_features, eps=1e-5)
        self.dwconv = ConvCL(
            hidden_features, hidden_features, 3, padding=1, groups=hidden_features
        )
        self.norm2 = nn.LayerNorm(hidden_features, eps=1e-5)
        self.fc = nn.Linear(hidden_features, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.tensor_shard
        if t is None:
            h = gelu(self.norm1(self.pwconv(x)))
            h = gelu(self.norm2(self.dwconv(h)))
            return x + self.fc(h)
        h = gelu(tensor_sharding.layer_norm(self.pwconv(t.copy(x)), self.norm1, t))
        h = gelu(tensor_sharding.layer_norm(self.dwconv(h), self.norm2, t))
        return x + tensor_sharding.row_parallel_linear(h, self.fc, t)


# Slice offsets of the reference PatchMerging (`wave_helper.py:183-190`),
# historical duplicates included: released checkpoints expect this order.
_PATCH_MERGE_OFFSETS: Tuple[Tuple[int, int, int], ...] = (
    (0, 0, 0),
    (1, 0, 0),
    (0, 1, 0),
    (0, 0, 1),
    (1, 0, 1),
    (0, 1, 0),
    (0, 0, 1),
    (1, 1, 1),
)


class PatchMerging(nn.Module):
    """2× downsample: 8-way strided gather → LN(8C) → Linear 8C→2C."""

    def __init__(self, dim: int, norm_eps: float = 1e-6):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=norm_eps)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gathered = torch.cat(
            [x[:, i::2, j::2, k::2, :] for (i, j, k) in _PATCH_MERGE_OFFSETS],
            dim=-1,
        )
        return self.reduction(self.norm(gathered))


class _UpsampleCL(nn.Module):
    """Trilinear ×stride with align_corners=True on channels-last input
    (the `nn.Upsample` at index 0 of the reference's Sequentials)."""

    depth_shard = None  # this rank's `spatial` line, set by `shard_model`

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        grid = list(x.shape[1:4])
        if self.depth_shard is not None:
            grid[0] *= self.depth_shard.size
        out = tuple(s * self.stride for s in grid)
        return spatial.resize_trilinear(x, out, True, self.depth_shard)


class ProjectionUpsample(nn.Module):
    """Learnable upsampling (reference `wave_helper.py:33-81`):
    trilinear ×s → dw 3³ conv → GroupNorm(C) → 1³ conv to 2C → GELU →
    projection conv(s), plus a trilinear + 1³ conv residual."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        stride: int = 2,
        residual: bool = True,
        use_double_conv: bool = False,
    ):
        super().__init__()
        c = in_channels
        self.conv1 = nn.Sequential(
            _UpsampleCL(stride), ConvCL(c, c, 3, padding=1, groups=c)
        )
        self.norm = ChannelGroupNorm(c)
        self.conv2 = ConvCL(c, 2 * c, 1)
        if use_double_conv:
            self.conv3 = nn.Sequential(
                ConvCL(2 * c, c, 1), nn.GELU(), ConvCL(c, out_channels, 1)
            )
        else:
            self.conv3 = ConvCL(2 * c, out_channels, 1)
        self.res_conv = (
            nn.Sequential(_UpsampleCL(stride), ConvCL(c, out_channels, 1))
            if residual
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = self.conv1[0](x)
        h = self.norm(self.conv1[1](up))
        h = self.conv3(gelu(self.conv2(h)))
        if self.res_conv is not None:
            h = h + self.res_conv[1](up)
        return h
