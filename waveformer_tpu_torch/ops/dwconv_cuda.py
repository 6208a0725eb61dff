"""Depthwise 3³ "same" conv stencil: CUDA kernel wrapper and plain version.

Port of `waveformer_tpu/ops/dwconv_pallas.py::dwconv3`. The kernel is
`csrc/dwconv3.cu` (see its header for the design). The interface is the
JAX one: x (B, D, H, W, C) channels-last, kernel (3, 3, 3, C); stride 1,
zero padding 1, fp32 accumulation. New beside it: an optional bias (C,),
added in fp32 before the one rounding to x's dtype (the JAX model adds the
conv bias right after the stencil; here it is the kernel's epilogue).

On a CPU tensor the wrapper runs `dwconv3_reference`; on a CUDA tensor it
launches the kernel or raises. Which of the kernel's two designs runs
depends on the dtype and C only (`design`): bf16 with C % 8 == 0 on the TMA
plane ring, the rest (fp32, C % 8 != 0) on the vector kernel.
`design_launches` counts the launches of each. The backward is a plain
composition, as the JAX kernel's is (`dwconv3_backward`): the 27 taps as
shifted multiply-adds and reductions in fp32. (The autograd of the grouped
`F.conv3d` would give the same gradients, but there cuDNN's grouped
weight gradient held a batch-2 flagship training step on an H100 at 4.5 s;
this composition brings the step to 0.39 s.)
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from waveformer_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# per-launch counter, read by chip_smoke.py to prove the main path ran here
launches = 0
# the kernel's designs, by the number `wft_dwconv3_design` returns, and the
# launches of each
DESIGNS = ("vector", "tma_ring")
design_launches = {name: 0 for name in DESIGNS}


def supported(c: int) -> bool:
    """Channel counts the kernel takes: any (16-byte vectors where C % 8 ==
    0, a masked element-wise tail otherwise)."""
    return c > 0


def design(dtype: torch.dtype, c: int) -> str:
    """The design `csrc/dwconv3.cu` launches for these arguments (its
    `wft_dwconv3_design`): bf16 with C % 8 == 0 (a W stride of whole 16
    bytes, as TMA needs) on the TMA plane ring, everything else on the
    vector kernel."""
    return "tma_ring" if dtype == torch.bfloat16 and c % 8 == 0 else "vector"


def dwconv3_reference(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor = None) -> torch.Tensor:
    """`F.conv3d(groups=C)` on the channels-first view of `x`, then `bias`
    (in x's dtype) added to the result."""
    c = x.shape[-1]
    w = kernel.permute(3, 0, 1, 2).unsqueeze(1).to(x.dtype)  # (C, 1, 3, 3, 3)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1, groups=c)
    y = y.permute(0, 2, 3, 4, 1).contiguous()
    return y if bias is None else y + bias.to(y.dtype)


def dwconv3_backward(x: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor):
    """(dx, dkernel, dbias) of `dwconv3(x, kernel, bias)` for the output
    gradient `g`, in fp32: dx is the stencil of g with the flipped kernel
    and dkernel[tap] the sum over voxels of the tap's shifted x times g, one
    shifted view a tap (zero padding 1 on D, H, W)."""
    d, h, w = x.shape[1:4]
    pad = (0, 0, 1, 1, 1, 1, 1, 1)
    xp = F.pad(x.float(), pad)
    g32 = g.float()
    gp = F.pad(g32, pad)
    k32 = kernel.float()
    dx = torch.zeros_like(g32)
    dk = torch.empty_like(k32)
    for a in range(3):
        for b in range(3):
            for c in range(3):
                xs = xp[:, a:a + d, b:b + h, c:c + w]
                dk[a, b, c] = torch.sum(xs * g32, dim=(0, 1, 2, 3))
                gs = gp[:, 2 - a:2 - a + d, 2 - b:2 - b + h, 2 - c:2 - c + w]
                dx.addcmul_(gs, k32[a, b, c])
    return dx, dk, g32.sum(dim=(0, 1, 2, 3))


def _launch(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    global launches
    b, d, h, w, c = x.shape
    if not supported(c):
        raise ValueError(f"dwconv3 kernel needs C > 0, got C={c}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dwconv3 kernel takes fp32/bf16, got {x.dtype}")
    if not (x.is_cuda and kernel.is_cuda and (bias is None or bias.is_cuda)):
        raise ValueError("dwconv3: inputs must be CUDA tensors")
    x = _build.aligned16(x)
    wts = _build.aligned16(kernel.to(torch.float32))
    bf = None if bias is None else _build.aligned16(bias.to(torch.float32))
    out = torch.empty_like(x)
    fn = _build.LIBRARIES.get("dwconv3").wft_dwconv3
    if fn.argtypes is None:  # once per loaded library
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
        )
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), wts.data_ptr(),
        None if bf is None else bf.data_ptr(), out.data_ptr(),
        b, d, h, w, c, torch.cuda.current_stream(x.device).cuda_stream,
    )
    name = design(x.dtype, c)
    _build.check(err, f"dwconv3 launch ({name})")
    launches += 1
    design_launches[name] += 1
    return out


def library_design(dtype: torch.dtype, c: int) -> str:
    """`wft_dwconv3_design` of the built library (the rule that `design`
    restates); needs nvcc."""
    fn = _build.LIBRARIES.get("dwconv3").wft_dwconv3_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2
    return DESIGNS[fn(_DTYPES[dtype], c)]


class _DWConv3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel, bias)
        if x.device.type == "cpu":
            return dwconv3_reference(x, kernel, bias)
        return _launch(x, kernel, bias)

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias = ctx.saved_tensors
        dx, dk, db = dwconv3_backward(x, kernel, g)
        return dx.to(x.dtype), dk.to(kernel.dtype), None if bias is None else db.to(bias.dtype)


def dwconv3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor = None) -> torch.Tensor:
    """Depthwise 3³ conv of channels-last `x` with `kernel` (3, 3, 3, C),
    plus `bias` (C,) if given; the result has x's dtype."""
    c = x.shape[-1]
    if tuple(kernel.shape) != (3, 3, 3, c):
        raise ValueError(f"dwconv3 kernel shape {tuple(kernel.shape)} != (3,3,3,{c})")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"dwconv3 bias shape {tuple(bias.shape)} != ({c},)")
    return _DWConv3.apply(x, kernel, bias)
