"""Shared model primitives: convs on channels-last tensors, norms, GELU.

Port of `waveformer_tpu/models/common.py`. The model keeps the JAX
package's channels-last (B, D, H, W, C) layout inside; a conv hands cuDNN
the channels-first *view* of that storage (PyTorch's `channels_last_3d`
format), so no copy is made. Parameters keep torch's shapes and the
reference `state_dict` names.

All the TPU lowerings of `_Conv3dCore` (space-to-depth, paired-W,
kd-grouped, scan-over-batch and their `WFTPU_*` gates) are one conv here:
a dense conv is cuDNN's, a 1³ conv is a matmul, and every depthwise 3³
conv goes through the hand-written stencil kernel (`ops/dwconv_cuda.py`).

Torch semantics kept from the reference: GELU is the exact erf form,
InstanceNorm has eps 1e-5 and no affine, LeakyReLU has slope 0.01.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from waveformer_tpu_torch.ops.dwconv_cuda import dwconv3


def to_cf(x: torch.Tensor) -> torch.Tensor:
    """Channels-last (B, D, H, W, C) → NCDHW view of the same storage."""
    return x.permute(0, 4, 1, 2, 3)


def to_cl(x: torch.Tensor) -> torch.Tensor:
    """NCDHW → channels-last (B, D, H, W, C) view."""
    return x.permute(0, 2, 3, 4, 1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch `nn.GELU()` semantics."""
    return F.gelu(x)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the spatial axes of channels-last x, no affine.
    Statistics and result are fp32."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (x32 - mean) * torch.rsqrt(var + eps)


class InstanceNormAffine(nn.Module):
    """`nn.InstanceNorm3d(affine=True)` on channels-last input."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = instance_norm(x, self.eps) * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class ChannelGroupNorm(InstanceNormAffine):
    """`nn.GroupNorm(C, C)`: per-channel statistics over space, affine
    (`ProjectionUpsample.norm`, reference `wave_helper.py:60`)."""


def layer_norm_stateless(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free layer norm over the channel axis, fp32 statistics
    (reference `waveformer.py:197-203` proj_out)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath, scale_by_keep=True).

    The masks are drawn from `generator`, a `torch.Generator` on x's device
    that the caller seeds (the trainer seeds one from (seed, step), where
    the JAX package folds the step into its dropout key); with none, from
    torch's default generator. The JAX dropout stream itself cannot be
    reproduced, so parity tests run with rate 0.

    Under data parallelism (`shard_drop_path`) rank r of W holds rows
    [r·b, (r+1)·b) of a global batch of W·b: it draws the global batch's
    masks from the same generator and keeps its own rows, so the ranks
    together drop what one process would drop on the whole batch."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.shard = (0, 1)  # (rank, world size) of the data axis

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        rank, world = self.shard
        b = x.shape[0]
        shape = (b * world,) + (1,) * (x.ndim - 1)
        mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=generator)
        return x * mask[rank * b:(rank + 1) * b].to(x.dtype) / keep


def shard_drop_path(model: nn.Module, rank: int, world: int) -> None:
    """Give every `DropPath` of `model` its rank's rows of the global
    batch's masks (see `DropPath`)."""
    for m in model.modules():
        if isinstance(m, DropPath):
            m.shard = (rank, world)


class ConvCL(nn.Conv3d):
    """`nn.Conv3d` (same parameters and names) applied to channels-last
    (B, D, H, W, C) input, returning channels-last output.

    A 1³ stride-1 conv is a matmul over channels; a depthwise 3³ stride-1
    conv with padding 1 is the stencil kernel, whose epilogue adds the bias
    (on the CPU the plain stencil plus the bias); anything else is
    `F.conv3d` on the channels-first view."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        c = self.in_channels
        if k == (1, 1, 1) and self.stride == (1, 1, 1) and self.groups == 1:
            return F.linear(x, self.weight.flatten(1), self.bias)
        if (
            k == (3, 3, 3)
            and self.stride == (1, 1, 1)
            and self.padding == (1, 1, 1)
            and self.groups == c == self.out_channels
        ):
            kernel = self.weight[:, 0].permute(1, 2, 3, 0)  # (3, 3, 3, C)
            return dwconv3(x, kernel, self.bias)
        return to_cl(super().forward(to_cf(x)))


class ConvTransposeCL(nn.ConvTranspose3d):
    """`nn.ConvTranspose3d` on channels-last input and output."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_cl(super().forward(to_cf(x)))


class Convolution(nn.Module):
    """MONAI `Convolution` shell: the conv sits at `.conv`, so the state
    dict keys read `<name>.conv.weight` as in the reference."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        bias: bool = False,
        transposed: bool = False,
    ):
        super().__init__()
        if transposed:
            self.conv = ConvTransposeCL(
                in_channels, out_channels, kernel_size, stride, bias=bias
            )
        else:
            self.conv = ConvCL(
                in_channels, out_channels, kernel_size, stride,
                padding=(kernel_size - stride + 1) // 2, bias=bias,
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding (MONAI `PatchEmbed`, patch_norm
    off): a k = s = patch conv, `proj`."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 2):
        super().__init__()
        self.proj = ConvCL(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)
