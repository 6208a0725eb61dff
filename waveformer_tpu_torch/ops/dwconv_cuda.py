"""Depthwise 3³ "same" conv stencil: CUDA kernel wrapper and plain version.

Port of `waveformer_tpu/ops/dwconv_pallas.py::dwconv3`. The kernel is
`csrc/dwconv3.cu` (see its header for the design). The interface is the
JAX one: x (B, D, H, W, C) channels-last, kernel (3, 3, 3, C); stride 1,
zero padding 1, fp32 accumulation, no bias (the caller adds it).

On a CPU tensor the wrapper runs `dwconv3_reference`; on a CUDA tensor it
launches the kernel or raises. The backward is the plain grouped conv.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from waveformer_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# per-launch counter, read by chip_smoke.py to prove the main path ran here
launches = 0


def supported(c: int) -> bool:
    """Channel counts the kernel takes: whole 8-channel vectors."""
    return c % 8 == 0 and c > 0


def dwconv3_reference(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """`F.conv3d(groups=C)` on the channels-first view of `x`."""
    c = x.shape[-1]
    w = kernel.permute(3, 0, 1, 2).unsqueeze(1).to(x.dtype)  # (C, 1, 3, 3, 3)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1, groups=c)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _launch(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    global launches
    b, d, h, w, c = x.shape
    if not supported(c):
        raise ValueError(f"dwconv3 kernel needs C % 8 == 0, got C={c}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dwconv3 kernel takes fp32/bf16, got {x.dtype}")
    if kernel.shape != (3, 3, 3, c):
        raise ValueError(f"dwconv3 kernel shape {tuple(kernel.shape)} != (3,3,3,{c})")
    if not (x.is_cuda and kernel.is_cuda):
        raise ValueError("dwconv3: inputs must be CUDA tensors")
    x = _build.aligned16(x)
    wts = kernel.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    fn = _build.LIBRARIES.get("dwconv3").wft_dwconv3
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), wts.data_ptr(), out.data_ptr(),
        b, d, h, w, c, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "dwconv3 launch")
    launches += 1
    return out


class _DWConv3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        if x.device.type == "cpu":
            return dwconv3_reference(x, kernel)
        return _launch(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        with torch.enable_grad():
            xi = x.detach().requires_grad_(True)
            ki = kernel.detach().requires_grad_(True)
            out = dwconv3_reference(xi, ki)
            gx, gk = torch.autograd.grad(out, (xi, ki), g.to(out.dtype))
        return gx, gk.to(kernel.dtype)


def dwconv3(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 3³ conv of channels-last `x` with `kernel` (3, 3, 3, C)."""
    return _DWConv3.apply(x, kernel)
