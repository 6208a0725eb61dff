"""Fused window attention: CUDA kernel wrapper and its plain version.

Port of `waveformer_tpu/ops/attention_pallas.py::window_attention`. The
kernel is `csrc/window_attention.cu` (see its header for the design). The
interface is the JAX one: q/k/v (B·nW, H, N, D), bias (H, N, N) fp32, a
Python float scale; the result is (B·nW, H, N, D) in the input dtype.
Shifted windows (Swin) add `labels`, (nW, N) uint8 shift-region labels of
window `b % nW`: −100 joins the score of every query and key whose labels
differ (MONAI's `compute_mask`); `masked_launches` counts those launches.

On a CPU tensor the wrapper runs `window_attention_reference`; on a CUDA
tensor it launches the kernel or raises. The kernel takes any N from 1 to
1024 and D from 1 to 64, in fp32 and bf16; which of its two designs runs
depends on the dtype and the shape only (`design`): bf16 with D ∈ {16, 32,
48, 64} and N ≤ 512 on the TMA + `wgmma` kernel, the rest on the fp32 FMA
kernel. `design_launches` counts the launches of each. The backward is the
plain composition, as `_bwd` of the JAX kernel is.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from waveformer_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# per-launch counter, read by chip_smoke.py to prove the main path ran here
launches = 0
# the kernel's designs, by the number `wft_window_attention_design` returns,
# and the launches of each
DESIGNS = ("fma", "tma_wgmma")
design_launches = {name: 0 for name in DESIGNS}
# launches with shift labels (counted in `design_launches` too)
masked_launches = 0
# the score MONAI's mask adds where a query's and a key's shift regions differ
MASK_VALUE = -100.0
# the kernel reads label rows padded with zeros to a multiple of this
LABEL_ROW_ALIGN = 128
TMA_HEAD_DIMS = (16, 32, 48, 64)


def supported(n: int, d: int) -> bool:
    """Shapes the kernel takes: N up to 1024 (the 32 or 64 bias rows of a
    block fit shared memory) and D up to 64 (registers)."""
    return 0 < n <= 1024 and 0 < d <= 64


def design(dtype: torch.dtype, n: int, d: int) -> str:
    """The design `csrc/window_attention.cu` launches for these arguments
    (its `wft_window_attention_design`): bf16 with D ∈ {16, 32, 48, 64}
    (whole 16-deep wgmma steps) and N ≤ 512 (64 bias rows of fp32 beside the
    K/V ring) on TMA + wgmma, everything else on the FMA kernel."""
    if dtype == torch.bfloat16 and d in TMA_HEAD_DIMS and n <= 512:
        return "tma_wgmma"
    return "fma"


def shift_mask(labels: torch.Tensor) -> torch.Tensor:
    """(nW, N) shift-region labels → MONAI's (nW, N, N) fp32 mask: −100
    where the query's and the key's labels differ, 0 where they match."""
    differ = labels[:, :, None] != labels[:, None, :]
    return torch.where(differ, MASK_VALUE, 0.0).to(torch.float32)


def window_attention_reference(q, k, v, bias, scale: float,
                               labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain composition (`attention_pallas.py::_reference`): fp32
    scores and softmax, probabilities cast to the input dtype before PV,
    fp32 accumulation; with `labels`, `shift_mask` added to the scores of
    window b at b % nW."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    s = s + bias.float()[None]
    if labels is not None:
        bw, h, n, _ = s.shape
        nw = labels.shape[0]
        s = (s.view(bw // nw, nw, h, n, n) + shift_mask(labels)[None, :, None]).view(bw, h, n, n)
    s = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", s.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _layout_ok(t: torch.Tensor) -> bool:
    """Rows the kernel can read: contiguous, and at D % 8 == 0 (16-byte
    vectors, TMA) 16-byte aligned with strides of whole 8-element vectors."""
    if t.stride(-1) != 1:
        return False
    return t.shape[-1] % 8 != 0 or (
        all(s % 8 == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0)


def _check_labels(labels: torch.Tensor, bw: int, n: int) -> None:
    if labels.dtype != torch.uint8 or labels.dim() != 2 or labels.shape[1] != n:
        raise ValueError(f"window_attention: labels (nW, {n}) uint8, got "
                         f"{tuple(labels.shape)} {labels.dtype}")
    if bw % labels.shape[0]:
        raise ValueError(f"window_attention: {labels.shape[0]} label rows do not divide "
                         f"{bw} windows")


def _padded_labels(labels: torch.Tensor) -> torch.Tensor:
    """The label rows zero-padded to a multiple of `LABEL_ROW_ALIGN`."""
    nw, n = labels.shape
    width = -(-n // LABEL_ROW_ALIGN) * LABEL_ROW_ALIGN
    out = labels.new_zeros((nw, width))
    out[:, :n] = labels
    return out


def _launch(q, k, v, bias, scale: float, labels: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    global launches, masked_launches
    bw, h, n, d = q.shape
    if not supported(n, d):
        raise ValueError(f"window_attention kernel does not take N={n}, D={d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"window_attention kernel takes fp32/bf16, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or bias.shape != (h, n, n):
        raise ValueError("window_attention: q/k/v (BW,H,N,D) and bias (H,N,N)")
    if not (q.is_cuda and k.is_cuda and v.is_cuda and bias.is_cuda):
        raise ValueError("window_attention: all inputs must be CUDA tensors")
    if labels is not None:
        _check_labels(labels, bw, n)
        if labels.device != q.device:
            raise ValueError("window_attention: labels must be on the inputs' device")
        labels = _padded_labels(labels)
    q, k, v = (t if _layout_ok(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    bias = bias.to(torch.float32).contiguous()
    if bias.data_ptr() % 16:  # the kernel loads the bias as float4
        bias = bias.clone()
    # (BW, N, H, D) storage: the caller's (BW, N, H·D) merge is then free
    out = torch.empty((bw, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    fn = _build.LIBRARIES.get("window_attention").wft_window_attention
    if fn.argtypes is None:  # once per loaded library
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_void_p]
        )
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    err = fn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), out.data_ptr(), *strides, bw, h, n, d, float(scale),
        None if labels is None else labels.data_ptr(),
        0 if labels is None else labels.shape[0], 0 if labels is None else labels.shape[1],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = design(q.dtype, n, d)
    _build.check(err, f"window_attention launch ({name})")
    launches += 1
    design_launches[name] += 1
    masked_launches += labels is not None
    return out


def library_design(dtype: torch.dtype, n: int, d: int) -> str:
    """`wft_window_attention_design` of the built library (the rule that
    `design` restates); needs nvcc."""
    fn = _build.LIBRARIES.get("window_attention").wft_window_attention_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return DESIGNS[fn(_DTYPES[dtype], n, d)]


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale, labels):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, labels)
        if q.device.type == "cpu":
            if labels is not None:
                _check_labels(labels, q.shape[0], q.shape[2])
            return window_attention_reference(q, k, v, bias, scale, labels)
        return _launch(q, k, v, bias, scale, labels)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, labels = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
            out = window_attention_reference(*ins, ctx.scale, labels)
            grads = torch.autograd.grad(out, ins, g.to(out.dtype))
        return (*grads, None, None)


def window_attention(q, k, v, bias, scale: float,
                     labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias [+ shift_mask(labels)])·v per window and
    head (see module doc)."""
    return _WindowAttention.apply(q, k, v, bias, scale, labels)
