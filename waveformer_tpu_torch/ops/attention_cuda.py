"""Fused window attention: CUDA kernel wrapper and its plain version.

Port of `waveformer_tpu/ops/attention_pallas.py::window_attention`. The
kernel is `csrc/window_attention.cu` (see its header for the design). The
interface is the JAX one: q/k/v (B·nW, H, N, D), bias (H, N, N) fp32, a
Python float scale; the result is (B·nW, H, N, D) in the input dtype.

On a CPU tensor the wrapper runs `window_attention_reference`; on a CUDA
tensor it launches the kernel or raises. The backward is the plain
composition, as `_bwd` of the JAX kernel is.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from waveformer_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# per-launch counter, read by chip_smoke.py to prove the main path ran here
launches = 0


def supported(n: int, d: int) -> bool:
    """Shapes the kernel takes: N a multiple of 64 up to 1024 (query and
    key tiles of 64; the 64 or 32 bias rows of a block fit shared memory),
    D a multiple of 8 up to 64 (16-byte vector loads, registers)."""
    return n % 64 == 0 and 0 < n <= 1024 and d % 8 == 0 and 0 < d <= 64


def window_attention_reference(q, k, v, bias, scale: float) -> torch.Tensor:
    """The plain composition (`attention_pallas.py::_reference`): fp32
    scores and softmax, probabilities cast to the input dtype before PV,
    fp32 accumulation."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    s = s + bias.float()[None]
    s = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", s.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _windows_per_block(bw: int, h: int, n: int, device: torch.device) -> int:
    """Windows per block so that about two waves of blocks cover the SMs:
    fewer windows per block re-read the bias more often, more leave SMs idle."""
    qt = 64 if n <= 512 else 32
    sms = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    per_window_blocks = (n // qt) * h
    groups = max(1, min(bw, -(-2 * sms // per_window_blocks)))
    return -(-bw // groups)


def _vector_ok(t: torch.Tensor) -> bool:
    return (
        t.stride(-1) == 1
        and all(s % 8 == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    )


def _launch(q, k, v, bias, scale: float) -> torch.Tensor:
    global launches
    bw, h, n, d = q.shape
    if not supported(n, d):
        raise ValueError(f"window_attention kernel does not take N={n}, D={d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"window_attention kernel takes fp32/bf16, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape or bias.shape != (h, n, n):
        raise ValueError("window_attention: q/k/v (BW,H,N,D) and bias (H,N,N)")
    if not (q.is_cuda and k.is_cuda and v.is_cuda and bias.is_cuda):
        raise ValueError("window_attention: all inputs must be CUDA tensors")
    q, k, v = (t if _vector_ok(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    bias = bias.to(torch.float32).contiguous()
    if bias.data_ptr() % 16:  # the kernel loads the bias as float4
        bias = bias.clone()
    # (BW, N, H, D) storage: the caller's (BW, N, H·D) merge is then free
    out = torch.empty((bw, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _build.LIBRARIES.get("window_attention")
    fn = lib.wft_window_attention
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    err = fn(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), out.data_ptr(), *strides, bw, h, n, d, float(scale),
        _windows_per_block(bw, h, n, q.device), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "window_attention launch")
    launches += 1
    return out


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias)
        if q.device.type == "cpu":
            return window_attention_reference(q, k, v, bias, scale)
        return _launch(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
            out = window_attention_reference(*ins, ctx.scale)
            grads = torch.autograd.grad(out, ins, g.to(out.dtype))
        return (*grads, None)


def window_attention(q, k, v, bias, scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale + bias)·v per window and head (see module doc)."""
    return _WindowAttention.apply(q, k, v, bias, scale)
