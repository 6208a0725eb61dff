"""CCF-FFN tail: CUDA kernel wrappers and plain versions.

Port of `tools/exp_ffn_pallas.py::ffn_tail`. The kernels are in
`csrc/ffn_tail.cu` (see its header for the designs). The tail computes

    out = gelu(LN(dwconv3(h1) + dw_b)) @ fc_w + fc_b

with h1 (B, D, H, W, Ch) channels-last, dw_w (3, 3, 3, Ch), dw_b, ln_s,
ln_b (Ch,), fc_w (Ch, C), fc_b (C,); out (B, D, H, W, C) in h1.dtype. The
caller adds the FFN residual. GELU is the exact erf form.

Which design runs depends on the dtype only (`design`): bf16 on
`split_wgmma`, two launches — the stencil and its bias on `dwconv3`'s TMA
plane ring (`ops/dwconv_cuda.py`, which rounds y to bf16 once), then
`ln_gelu_dense` (LayerNorm → GELU → Dense on TMA + wgmma) on y — and fp32 on
`fp32`, one fused kernel. `launches` counts `ffn_tail` calls on the card,
`design_launches` each design's, `ln_gelu_dense_launches` the second
kernel's.

On a CPU tensor the wrappers run `ffn_tail_reference` and
`ln_gelu_dense_reference`; on a CUDA tensor they launch the kernels or
raise. The backward is the plain composition, as the JAX `custom_vjp` is.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from waveformer_tpu_torch.models.common import gelu
from waveformer_tpu_torch.ops import _build
from waveformer_tpu_torch.ops.dwconv_cuda import dwconv3, dwconv3_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the widest Ch of `ln_gelu_dense`: one 64-row block of y in shared memory
MAX_BF16_CH = 1600

# per-call counter of `ffn_tail` on the card, read by chip_smoke.py to prove
# the path ran here
launches = 0
# the designs, by the number `wft_ffn_tail_design` returns, and the calls of each
DESIGNS = ("fp32", "split_wgmma")
design_launches = {name: 0 for name in DESIGNS}
# launches of the `ln_gelu_dense` kernel (the second of `split_wgmma`'s two)
ln_gelu_dense_launches = 0


def supported(ch: int, c: int, dtype: torch.dtype) -> bool:
    """Widths the kernel takes: whole 8-channel vectors of h1; for bf16,
    16-deep K steps and 8-wide output tiles of the tensor-core product."""
    if dtype == torch.bfloat16:
        return ch % 16 == 0 and ch > 0 and c % 8 == 0 and c > 0
    return ch % 8 == 0 and ch > 0 and c > 0


def design(dtype: torch.dtype, ch: int, c: int) -> str:
    """The design `csrc/ffn_tail.cu` runs for these arguments (its
    `wft_ffn_tail_design`): bf16 on `split_wgmma` (the stencil ring, then
    `ln_gelu_dense`), fp32 on the one-launch `fp32` kernel."""
    return "split_wgmma" if dtype == torch.bfloat16 else "fp32"


def library_design(dtype: torch.dtype, ch: int, c: int) -> str:
    """`wft_ffn_tail_design` of the built library (the rule that `design`
    restates); needs nvcc."""
    fn = _build.LIBRARIES.get("ffn_tail").wft_ffn_tail_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    return DESIGNS[fn(_DTYPES[dtype], ch, c)]


def ffn_tail_reference(h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b, eps: float = 1e-5):
    """The plain composition (JAX `_ffn_tail_reference`): the stencil and
    its bias in h1.dtype, LayerNorm and GELU in fp32, the Dense in h1.dtype."""
    dt = h1.dtype
    out = dwconv3_reference(h1, dw_w) + dw_b.to(dt)
    out = F.layer_norm(out.float(), (out.shape[-1],), ln_s.float(), ln_b.float(), eps)
    out = gelu(out).to(dt)
    return F.linear(out, fc_w.t().to(dt), fc_b.to(dt))


def ln_gelu_dense_reference(y, ln_s, ln_b, fc_w, fc_b, eps: float = 1e-5):
    """The plain version of `ln_gelu_dense`: LayerNorm of y's last axis and
    GELU in fp32, rounded to y.dtype; the Dense (fc_w (Ch, C)) in fp32 on
    those values, plus fc_b, rounded once to y.dtype."""
    dt = y.dtype
    a = F.layer_norm(y.float(), (y.shape[-1],), ln_s.float(), ln_b.float(), eps)
    a = gelu(a).to(dt).float()
    return (a @ fc_w.to(dt).float() + fc_b.float()).to(dt)


def _launch_ln_gelu_dense(y, ln_s, ln_b, fc_w, fc_b, eps: float) -> torch.Tensor:
    global ln_gelu_dense_launches
    ch = y.shape[-1]
    c = fc_w.shape[-1]
    if y.dtype != torch.bfloat16:
        raise TypeError(f"ln_gelu_dense kernel takes bf16, got {y.dtype}")
    if not supported(ch, c, y.dtype) or ch > MAX_BF16_CH:
        raise ValueError(f"ln_gelu_dense kernel does not take Ch={ch}, C={c}")
    if fc_w.shape != (ch, c) or tuple(ln_s.shape) != (ch,) or tuple(ln_b.shape) != (ch,) \
            or tuple(fc_b.shape) != (c,):
        raise ValueError(f"ln_gelu_dense: fc_w {tuple(fc_w.shape)} for y {tuple(y.shape)}")
    if not all(t.is_cuda for t in (y, ln_s, ln_b, fc_w, fc_b)):
        raise ValueError("ln_gelu_dense: all inputs must be CUDA tensors")
    f32 = [_build.aligned16(t.to(torch.float32).reshape(-1)) for t in (ln_s, ln_b, fc_b)]
    y = _build.aligned16(y)
    fcw = _build.aligned16(fc_w.t().to(torch.bfloat16))  # (C, Ch), K-major for wgmma
    m = y.numel() // ch
    out = torch.empty((*y.shape[:-1], c), dtype=y.dtype, device=y.device)
    if m == 0:
        return out
    fn = _build.LIBRARIES.get("ffn_tail").wft_ln_gelu_dense
    if fn.argtypes is None:  # once per loaded library
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_void_p]
    err = fn(y.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), fcw.data_ptr(),
             f32[2].data_ptr(), out.data_ptr(), m, ch, c, float(eps),
             torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "ln_gelu_dense launch")
    ln_gelu_dense_launches += 1
    return out


def ln_gelu_dense(y, ln_s, ln_b, fc_w, fc_b, eps: float = 1e-5) -> torch.Tensor:
    """gelu(LN(y)) @ fc_w + fc_b over y's last axis (Ch), fc_w (Ch, C): the
    second launch of the bf16 tail. CPU tensors take the plain version."""
    if y.device.type == "cpu":
        return ln_gelu_dense_reference(y, ln_s, ln_b, fc_w, fc_b, eps)
    return _launch_ln_gelu_dense(y, ln_s, ln_b, fc_w, fc_b, eps)


def _launch(h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b, eps: float) -> torch.Tensor:
    global launches
    b, d, h, w, ch = h1.shape
    c = fc_w.shape[-1]
    if h1.dtype not in _DTYPES:
        raise TypeError(f"ffn_tail kernel takes fp32/bf16, got {h1.dtype}")
    if not supported(ch, c, h1.dtype):
        raise ValueError(f"ffn_tail kernel does not take Ch={ch}, C={c} in {h1.dtype}")
    if dw_w.shape != (3, 3, 3, ch) or fc_w.shape != (ch, c):
        raise ValueError(f"ffn_tail: dw_w {tuple(dw_w.shape)}, fc_w {tuple(fc_w.shape)}")
    tensors = (h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("ffn_tail: all inputs must be CUDA tensors")
    name = design(h1.dtype, ch, c)
    if name == "split_wgmma":
        if ch > MAX_BF16_CH:
            raise ValueError(f"ffn_tail kernel does not take Ch={ch} > {MAX_BF16_CH} in bf16")
        out = _launch_ln_gelu_dense(dwconv3(h1, dw_w, dw_b), ln_s, ln_b, fc_w, fc_b, eps)
    else:
        f32 = [_build.aligned16(t.to(torch.float32).reshape(-1))
               for t in (dw_w, dw_b, ln_s, ln_b, fc_b)]
        h1 = _build.aligned16(h1)
        fcw = fc_w.t().to(h1.dtype).contiguous()  # (C, Ch)
        out = torch.empty((b, d, h, w, c), dtype=h1.dtype, device=h1.device)
        fn = _build.LIBRARIES.get("ffn_tail").wft_ffn_tail
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        err = fn(
            _DTYPES[h1.dtype], h1.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(),
            f32[2].data_ptr(), f32[3].data_ptr(), fcw.data_ptr(), f32[4].data_ptr(),
            out.data_ptr(), b, d, h, w, ch, c, float(eps),
            torch.cuda.current_stream(h1.device).cuda_stream,
        )
        _build.check(err, "ffn_tail launch (fp32)")
    launches += 1
    design_launches[name] += 1
    return out


class _FFNTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b, eps):
        ctx.eps = eps
        ctx.save_for_backward(h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b)
        if h1.device.type == "cpu":
            return ffn_tail_reference(h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b, eps)
        return _launch(h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b, eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = ffn_tail_reference(*ins, ctx.eps)
            grads = torch.autograd.grad(out, ins, g.to(out.dtype))
        return (*grads, None)


def ffn_tail(h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b, eps: float = 1e-5):
    """The dwconv3 → LN → GELU → Dense tail (see module doc)."""
    return _FFNTail.apply(h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b, eps)


def ffn_tail_module(ffn: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A port `CCF_FFN` (`models/layers.py`) on `x` with the tail on the
    kernel: pwconv → LN → GELU through the module's own layers, then
    `ffn_tail`, then the FFN's residual. Equals `ffn(x)`."""
    h = gelu(ffn.norm1(ffn.pwconv(x)))
    dw_w = ffn.dwconv.weight[:, 0].permute(1, 2, 3, 0)  # (Ch, 1, 3, 3, 3) → (3, 3, 3, Ch)
    return x + ffn_tail(h, dw_w, ffn.dwconv.bias, ffn.norm2.weight, ffn.norm2.bias,
                        ffn.fc.weight.t(), ffn.fc.bias, ffn.norm2.eps)
