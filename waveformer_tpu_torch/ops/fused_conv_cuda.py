"""Fused 3³ conv with InstanceNorm prologue/epilogue, and the fused UnetResBlock.

Port of `tools/exp_fused_conv.py`. `conv3x3x3_fused` is the dense 3³ conv
of `csrc/conv3.cu` (through `ops/conv_cuda.py::launch`) with two options:

  * `prologue=(mean, rstd)`: the input is instance-normalised on load (and
    LeakyReLU'd when `act`), then rounded to the input dtype; the SAME halo
    stays zero after normalisation;
  * `emit_stats=True`: also return (B, 2, O) fp32 [Σ, Σ²] of the unrounded
    fp32 accumulator, per instance, summed in a fixed order (two calls give
    bit-identical statistics).

`res_block_fused` runs an `UnetResBlock` forward on two such convs: conv1
emits the statistics of its output, conv2 normalises that output on load and
emits its own; the 1³ shortcut and the final norm + LeakyReLU are plain
PyTorch (`torch.matmul`), as JAX computes them outside Pallas. Its backward
recomputes through `res_block_reference`, as the JAX `custom_vjp` does.

Layout: channels-last with a leading batch, x (B, D, H, W, C), weights
(3, 3, 3, C, O) (1³ shortcut (1, 1, 1, C, O)). On CPU tensors the plain
versions run; on CUDA tensors the kernel is launched or the call raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from waveformer_tpu_torch.models.common import instance_norm, leaky_relu
from waveformer_tpu_torch.ops import conv_cuda

NEG_SLOPE = 0.01  # MONAI dynunet LeakyReLU slope
EPS = 1e-5

# launches of the fused conv kernel, read by chip_smoke.py
launches = 0


def _per_instance(t: torch.Tensor) -> torch.Tensor:
    """(B, C) → (B, 1, 1, 1, C) for broadcasting over channels-last space."""
    return t[:, None, None, None, :]


def conv3x3x3_fused_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    emit_stats: bool = False,
    act: bool = True,
):
    """The plain version: the same prologue and rounding, the conv summed in
    fp32 on the rounded inputs (`F.conv3d`), stats of the fp32 result."""
    if prologue is not None:
        mean, rstd = (t.float().expand(x.shape[0], x.shape[-1]) for t in prologue)
        z = (x.float() - _per_instance(mean)) * _per_instance(rstd)
        if act:
            z = F.leaky_relu(z, NEG_SLOPE)
        x = z.to(x.dtype)
    acc = conv_cuda.conv3x3x3_reference(x.float(), w.to(x.dtype).float())
    y = acc.to(x.dtype)
    if not emit_stats:
        return y
    stats = torch.stack([acc.sum(dim=(1, 2, 3)), (acc * acc).sum(dim=(1, 2, 3))], dim=1)
    return y, stats


def conv3x3x3_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    emit_stats: bool = False,
    act: bool = True,
):
    """'SAME' 3³ conv (B, D, H, W, C) × (3, 3, 3, C, O) → (B, D, H, W, O)
    in x.dtype, or (y, stats (B, 2, O) fp32) with `emit_stats`. `prologue`
    is (mean, rstd), each (B, C) (or (C,), shared by the batch). No
    gradient: `res_block_fused` is the differentiable entry point."""
    global launches
    if x.device.type == "cpu":
        return conv3x3x3_fused_reference(x, w, prologue, emit_stats, act)
    y, stats = conv_cuda.launch(x, w, conv_cuda.DHWC, prologue, act, emit_stats)
    launches += 1
    return (y, stats) if emit_stats else y


def moments_from_stats(st: torch.Tensor, n: int, eps: float = EPS):
    """(..., 2, O) [Σ, Σ²] → per-channel (mean, rstd) over n voxels; the
    variance E[x²] − E[x]² is clamped at 0."""
    mean = st[..., 0, :] / n
    var = torch.clamp(st[..., 1, :] / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def res_block_reference(x, w1, w2, w3=None, conv=conv_cuda.conv3x3x3_reference):
    """`UnetResBlock` without module scaffolding (JAX `_res_block_xla`):
    conv3 → IN → lrelu → conv3 → IN (+ IN(1³ shortcut) or x) → lrelu.
    `conv` computes each 3³ conv; the default is the plain version."""
    h = leaky_relu(instance_norm(conv(x, w1)), NEG_SLOPE).to(x.dtype)
    h = instance_norm(conv(h, w2))
    if w3 is not None:
        r = instance_norm(torch.matmul(x, w3.reshape(w3.shape[-2:]).to(x.dtype)))
    else:
        r = x.float()
    return leaky_relu(h + r, NEG_SLOPE).to(x.dtype)


def _res_block_fused_impl(x, w1, w2, w3):
    n = x.shape[1] * x.shape[2] * x.shape[3]
    y1, st1 = conv3x3x3_fused(x, w1, emit_stats=True, act=False)
    m1, r1 = moments_from_stats(st1, n)
    y2, st2 = conv3x3x3_fused(y1, w2, prologue=(m1, r1), emit_stats=True, act=True)
    m2, r2 = moments_from_stats(st2, n)
    if w3 is not None:
        s = torch.matmul(x, w3.reshape(w3.shape[-2:]).to(x.dtype)).float()
        ms = s.mean(dim=(1, 2, 3), keepdim=True)
        vs = torch.clamp((s * s).mean(dim=(1, 2, 3), keepdim=True) - ms * ms, min=0.0)
        resid = (s - ms) * torch.rsqrt(vs + EPS)
    else:
        resid = x.float()
    out = (y2.float() - _per_instance(m2)) * _per_instance(r2) + resid
    return F.leaky_relu(out, NEG_SLOPE).to(x.dtype)


class _ResBlockFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, w3):
        ctx.save_for_backward(x, w1, w2, w3)
        return _res_block_fused_impl(x, w1, w2, w3)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) if t is not None else None for t in saved]
            out = res_block_reference(*ins)
            wanted = [t for t in ins if t is not None]
            grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
        return tuple(next(grads) if t is not None else None for t in ins)


def res_block_fused(x, w1, w2, w3=None):
    """`UnetResBlock` forward on the fused conv: (B, D, H, W, C) →
    (B, D, H, W, O); w1 (3, 3, 3, C, O), w2 (3, 3, 3, O, O), w3 the 1³
    shortcut (1, 1, 1, C, O) or None when C == O."""
    return _ResBlockFused.apply(x, w1, w2, w3)


def res_block_weights(block: torch.nn.Module):
    """(w1, w2, w3 or None) of a port `UnetResBlock` (`models/conv_blocks.py`)
    in the JAX layout: (O, C, kD, kH, kW) → (kD, kH, kW, C, O)."""
    convs = (block.conv1, block.conv2, block.conv3)
    return tuple(None if c is None else c.conv.weight.permute(2, 3, 4, 1, 0) for c in convs)


def res_block_fused_module(block: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Run a port `UnetResBlock` on `x` through `res_block_fused`, with the
    block's own weights."""
    return res_block_fused(x, *res_block_weights(block))
