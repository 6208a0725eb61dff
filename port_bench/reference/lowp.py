"""The lower-precision control: the reference with every product operand
rounded to float8 (e4m3, one scale a tensor: its largest magnitude maps to
448), the step below the bfloat16 that the configurations state. Gradients
pass the rounding unchanged (straight through)."""

from __future__ import annotations

import torch


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()
