"""The reference's precision: float32 products kept in float32
(`plain_precision`), and the lower-precision control: the reference with
every product operand rounded to float8 (e4m3, one scale a tensor: its
largest magnitude maps to 448), the step below the bfloat16 that the
configurations state. Gradients pass the rounding unchanged (straight
through)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def plain_precision():
    """float32 products in float32: TF32 off for matmuls and cuDNN, restored
    afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()
