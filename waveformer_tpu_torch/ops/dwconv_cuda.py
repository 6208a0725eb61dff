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
`design_launches` counts the forward launches of each.

The backward on a CUDA tensor is two kernels of `csrc/dwconv3.cu`
(`backward_kernels`), on the same design rule; it replaces the JAX kernel's
plain `custom_vjp` composition (there is no Pallas backward). dx is the
forward kernel run on g with the taps flipped on all three axes (fp32 sums,
one rounding to x's dtype); the weight gradient `wft_dwconv3_wgrad` reads x
and g once each (in bf16 on `tma_ring`) and sums the 27 shifted products
and Σ g of every channel in fp32, block partials summed in a fixed order,
so the same inputs give the same bits. Both are bound by bytes: over the
ten calls of a batch-4 training step each moves 3.35 GB in bf16, ≈ 1 ms
at 3.35 TB/s. `backward_design_launches` counts them (`dgrad_*`, `wgrad_*`);
`launches` and `design_launches` count forward calls only. On a CPU tensor
the backward is `dwconv3_backward`, the plain composition: the 27 taps as
shifted multiply-adds and reductions in fp32 (float64 for float64 inputs).
(The autograd of the grouped `F.conv3d` would give the same gradients, but
there cuDNN's grouped weight gradient held a batch-2 flagship training
step on an H100 at 4.5 s.)
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
# the backward's launches, by kernel (dgrad: the forward kernel on the
# flipped taps; wgrad: `wft_dwconv3_wgrad`) and design
BACKWARD_DESIGNS = tuple(f"{k}_{name}" for k in ("dgrad", "wgrad") for name in DESIGNS)
backward_design_launches = {name: 0 for name in BACKWARD_DESIGNS}


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
    gradient `g`, in fp32 (float64 for float64 inputs): dx is the stencil of
    g with the flipped kernel and dkernel[tap] the sum over voxels of the
    tap's shifted x times g, one shifted view a tap (zero padding 1 on D, H,
    W)."""
    d, h, w = x.shape[1:4]
    acc = torch.promote_types(x.dtype, torch.float32)
    pad = (0, 0, 1, 1, 1, 1, 1, 1)
    xp = F.pad(x.to(acc), pad)
    g32 = g.to(acc)
    gp = F.pad(g32, pad)
    k32 = kernel.to(acc)
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


def _checked(x: torch.Tensor, *others: torch.Tensor) -> None:
    if not supported(x.shape[-1]):
        raise ValueError(f"dwconv3 kernel needs C > 0, got C={x.shape[-1]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dwconv3 kernel takes fp32/bf16, got {x.dtype}")
    if not all(t is None or t.is_cuda for t in (x, *others)):
        raise ValueError("dwconv3: inputs must be CUDA tensors")


def _run(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One launch of the stencil kernel, counted by the caller."""
    b, d, h, w, c = x.shape
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
    _build.check(err, f"dwconv3 launch ({design(x.dtype, c)})")
    return out


def _launch(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    global launches
    _checked(x, kernel, bias)
    out = _run(x, kernel, bias)
    launches += 1
    design_launches[design(x.dtype, x.shape[-1])] += 1
    return out


def backward_kernels(x: torch.Tensor, kernel: torch.Tensor, g: torch.Tensor,
                     with_bias: bool = True):
    """(dx, dkernel, dbias) of `dwconv3(x, kernel, bias)` on the card: dx in
    x's dtype, dkernel (3, 3, 3, C) and dbias (C,) in fp32 (dbias None
    without `with_bias`). Two kernels: the stencil on g with the flipped
    taps, then `wft_dwconv3_wgrad`."""
    _checked(x, kernel, g)
    if g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"dwconv3 backward: gradient {g.dtype} {tuple(g.shape)} "
                         f"against input {x.dtype} {tuple(x.shape)}")
    b, d, h, w, c = x.shape
    name = design(x.dtype, c)
    g = _build.aligned16(g)
    dx = _run(g, kernel.flip((0, 1, 2)), None)
    backward_design_launches[f"dgrad_{name}"] += 1
    x = _build.aligned16(x)
    lib = _build.LIBRARIES.get("dwconv3")
    size, fn = lib.wft_dwconv3_wgrad_workspace, lib.wft_dwconv3_wgrad
    if fn.argtypes is None:  # once per loaded library
        size.restype = ctypes.c_longlong
        size.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
    n = size(_DTYPES[x.dtype], b, d, h, w, c)
    if n < 0:
        raise ValueError(f"dwconv3 wgrad refuses {x.dtype} {tuple(x.shape)}")
    part = torch.empty(n, dtype=torch.float32, device=x.device)
    dk = torch.empty(3, 3, 3, c, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device) if with_bias else None
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), part.data_ptr(), n, dk.data_ptr(),
        None if db is None else db.data_ptr(), b, d, h, w, c,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"dwconv3 wgrad launch ({name})")
    backward_design_launches[f"wgrad_{name}"] += 1
    return dx, dk, db


def library_design(dtype: torch.dtype, c: int, wgrad: bool = False) -> str:
    """`wft_dwconv3_design` (or, with `wgrad`, `wft_dwconv3_wgrad_design`)
    of the built library (the rule that `design` restates); needs nvcc."""
    lib = _build.LIBRARIES.get("dwconv3")
    fn = lib.wft_dwconv3_wgrad_design if wgrad else lib.wft_dwconv3_design
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
        if x.device.type == "cpu":
            dx, dk, db = dwconv3_backward(x, kernel, g)
        else:
            dx, dk, db = backward_kernels(x, kernel, g, bias is not None)
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
