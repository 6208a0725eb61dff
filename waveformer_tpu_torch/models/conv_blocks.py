"""Convolutional encoder/decoder blocks (MONAI dynunet/unetr equivalents).

Port of `waveformer_tpu/models/conv_blocks.py`: `UnetResBlock`,
`UnetBasicBlock`, `UnetrBasicBlock`, `UnetrUpBlock`, `UnetOutBlock` and the
reference's `ProjectionHead` and `ChannelCalibration`. Channels-last, InstanceNorm without
affine (eps 1e-5, fp32 statistics), LeakyReLU 0.01, bias-free convs except
the 1³ output head. The TPU batch scan (`_scan_over_batch`) has no
counterpart: PyTorch runs the batch in one call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from waveformer_tpu_torch.models.common import (
    ConvCL,
    Convolution,
    instance_norm,
    leaky_relu,
)
from waveformer_tpu_torch.parallel.collectives import SyncBatchNorm


class UnetResBlock(nn.Module):
    """conv3→IN→lrelu→conv3→IN (+1³ shortcut if channels change)→+→lrelu."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = Convolution(in_channels, out_channels, kernel_size)
        self.conv2 = Convolution(out_channels, out_channels, kernel_size)
        self.conv3 = (
            Convolution(in_channels, out_channels, 1)
            if in_channels != out_channels
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        h = leaky_relu(instance_norm(self.conv1(x))).to(dtype)
        h = instance_norm(self.conv2(h))
        residual = x.float() if self.conv3 is None else instance_norm(self.conv3(x))
        return leaky_relu(h + residual).to(dtype)


class UnetBasicBlock(nn.Module):
    """conv3→IN→lrelu→conv3→IN→lrelu, no shortcut."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = Convolution(in_channels, out_channels, kernel_size)
        self.conv2 = Convolution(out_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        h = leaky_relu(instance_norm(self.conv1(x))).to(dtype)
        return leaky_relu(instance_norm(self.conv2(h))).to(dtype)


def _res_or_basic(res_block: bool, cin: int, cout: int, k: int) -> nn.Module:
    return (UnetResBlock if res_block else UnetBasicBlock)(cin, cout, k)


class UnetrBasicBlock(nn.Module):
    """Skip-encoder block: the res (or basic) block at `layer`."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int = 3,
        res_block: bool = True,
    ):
        super().__init__()
        self.layer = _res_or_basic(res_block, in_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """Final up block: convT(k2 s2) → concat skip → res (or basic) block."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int = 3,
        res_block: bool = True,
    ):
        super().__init__()
        self.transp_conv = Convolution(
            in_channels, out_channels, 2, stride=2, transposed=True
        )
        self.conv_block = _res_or_basic(
            res_block, 2 * out_channels, out_channels, kernel_size
        )

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = self.transp_conv(x)
        return self.conv_block(torch.cat([up, skip], dim=-1))


class UnetOutBlock(nn.Module):
    """1³ conv head with bias."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Convolution(in_channels, out_channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ProjectionHead(nn.Module):
    """Contrastive projection head (`network_models/network_backbone.py:35-63`).

    `proj='convmlp'` (the reference's default): 1³ conv → BatchNorm + ReLU
    (`lib/models/tools/module_helper.py:29-34`) → 1³ conv; `proj='linear'`:
    one 1³ conv. Then L2 over channels with torch's 1e-12 floor
    (`F.normalize(p=2, dim=1)`), in fp32. Channels-last (B, D, H, W, C),
    output in the input's dtype. The modules sit where the reference's do,
    so its state dict keys (`proj.0`, `proj.1.0`, `proj.2`, or `proj`)
    load as they are. The BatchNorm is `SyncBatchNorm` (fp32, flax's
    momentum 0.9, as JAX's `nn.BatchNorm` here): plain BatchNorm with no
    `group`, global-batch moments over the ranks of `group` (what the
    reference's DDP `convert_sync_batchnorm` makes of it, and what JAX's
    BatchNorm sees on its global batch). In eval mode it uses the running
    statistics (JAX's `deterministic=True`)."""

    def __init__(self, dim_in: int, proj_dim: int = 256, proj: str = "convmlp",
                 group: Optional[dist.ProcessGroup] = None):
        super().__init__()
        if proj == "linear":
            self.proj = ConvCL(dim_in, proj_dim, 1)
        elif proj == "convmlp":
            self.proj = nn.Sequential(
                ConvCL(dim_in, dim_in, 1),
                nn.Sequential(SyncBatchNorm(dim_in, group), nn.ReLU()),
                ConvCL(dim_in, proj_dim, 1),
            )
        else:
            raise ValueError(f"Unknown projection type: {proj}")
        self.kind = proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        if self.kind == "linear":
            h = self.proj(x)
        else:
            conv0, (bn, _), conv2 = self.proj
            h = conv2(F.relu(bn(conv0(x))).to(dtype))
        h32 = h.float()
        norm = torch.clamp(torch.linalg.vector_norm(h32, dim=-1, keepdim=True), min=1e-12)
        return (h32 / norm).to(dtype)


class ChannelCalibration(nn.Module):
    """SE-style bottleneck recalibration (`network_backbone.py:66-128`):
    1³ reduce → IN → relu → 3³ conv → IN → relu → 1³ expand → IN → SE gate
    (pool → fc → relu → fc → sigmoid) → ×, + 1³ residual → relu."""

    def __init__(self, in_channels: int, reduction_ratio: int = 4):
        super().__init__()
        c = in_channels
        rc = c // reduction_ratio
        self.reduce = ConvCL(c, rc, 1)
        self.conv = ConvCL(rc, rc, 3, padding=1)
        self.expand = ConvCL(rc, c, 1)
        self.residual = ConvCL(c, c, 1)
        self.fc1 = nn.Linear(c, rc)
        self.fc2 = nn.Linear(rc, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        identity = self.residual(x)
        h = F.relu(instance_norm(self.reduce(x))).to(dtype)
        h = F.relu(instance_norm(self.conv(h))).to(dtype)
        h = instance_norm(self.expand(h)).to(dtype)
        se = h.mean(dim=(1, 2, 3))
        se = torch.sigmoid(self.fc2(F.relu(self.fc1(se))))
        h = h * se[:, None, None, None, :]
        return F.relu(h.float() + identity.float()).to(dtype)
