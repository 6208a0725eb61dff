"""Dense 3³ "same" conv as an implicit GEMM: CUDA kernel wrappers and plain version.

Port of `waveformer_tpu/ops/conv_pallas.py`. The kernel is `csrc/conv3.cu`
(see its header for the design); `ops/fused_conv_cuda.py` drives the same
kernel with its InstanceNorm prologue and statistics epilogue. The
interfaces are the JAX ones:

  conv3x3x3_same     (D, H, W, C) × (3, 3, 3, C, O) → (D, H, W, O)
  conv3x3x3_batched  (B, D, H, W, C) → (B, D, H, W, O), one launch
  conv3x3x3_cw       (D, H, C, W) → (D, H, O, W); a leading B is also taken
  conv3x3x3_same_v2  (D, H, W, C) through the (D, H, C, W) kernel; a
                     leading B is also taken

Stride 1, zero padding 1, no bias, fp32 accumulation, the result in the
input dtype. `block_h` is the TPU kernels' row tiling: it is kept so that an
H it does not divide raises `ValueError` as in JAX, and the CUDA tiling does
not depend on it.

On CPU tensors every wrapper runs `conv3x3x3_reference`; on CUDA tensors it
launches the kernel or raises (fp32 with TF32 off is an FMA loop, bf16 runs
on tensor cores). Which of the kernel's designs runs depends on the dtype,
the layout and the shape only (`design`): bf16 channels-last with C % 8 ==
0 on the channels-last TMA + `wgmma` kernel, other bf16 channels-last with
C % 4 == 0 on the halo-tile `mma.sync` kernel, bf16 (D, H, C, W) with W % 8
== 0 on the (D, H, C, W) TMA + `wgmma` kernel (both TMA kernels take the
weights in the `pack_taps` order), the rest on the plain kernel.
`design_launches` counts the launches of each.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from waveformer_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DHWC, DHCW = 0, 1

# per-entry-point launch counters, read by chip_smoke.py
launches = {"conv3x3x3_same": 0, "conv3x3x3_batched": 0, "conv3x3x3_cw": 0,
            "conv3x3x3_same_v2": 0}
# the kernel's designs, by the number `wft_conv3_design` returns, and the
# launches of each (every launch of csrc/conv3.cu, the fused conv's included)
DESIGNS = ("halo_mma", "plain", "tma_wgmma", "tma_wgmma_cl")
design_launches = {name: 0 for name in DESIGNS}


def conv3x3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`F.conv3d` on the channels-first view of channels-last `x`
    ((D, H, W, C) or (B, D, H, W, C)) with `w` (3, 3, 3, C, O)."""
    single = x.dim() == 4
    xb = x[None] if single else x
    wt = w.permute(4, 3, 0, 1, 2).to(x.dtype)  # (O, C, 3, 3, 3)
    y = F.conv3d(xb.permute(0, 4, 1, 2, 3), wt, padding=1).permute(0, 2, 3, 4, 1)
    y = y.contiguous()
    return y[0] if single else y


def pack_taps(w: torch.Tensor) -> torch.Tensor:
    """Weights (3, 3, 3, C, O) in the TMA kernel's per-tap order: (ceil(C /
    16), 3, 9, O, 16), element [chunk, kd, kh·3 + kw, o, c − 16·chunk], zero
    for channels past C, so a 16-channel box never reads another tap."""
    c, o = w.shape[3], w.shape[4]
    chunks = -(-c // 16)
    wp = torch.zeros((27, chunks * 16, o), dtype=w.dtype, device=w.device)
    wp[:, :c] = w.reshape(27, c, o)
    return wp.reshape(3, 9, chunks, 16, o).permute(2, 0, 1, 4, 3).contiguous()


def design(dtype: torch.dtype, layout: int, w_extent: int, c: int) -> str:
    """The design `csrc/conv3.cu` launches for these arguments (its
    `wft_conv3_design`): bf16 channels-last with C % 8 == 0 (a W stride of
    whole 16 bytes, as TMA needs) on `tma_wgmma_cl`, other bf16
    channels-last with C % 4 == 0 on `halo_mma`, bf16 (D, H, C, W) with
    W % 8 == 0 on `tma_wgmma`, everything else on `plain`."""
    if dtype == torch.bfloat16:
        if layout == DHWC and c % 8 == 0:
            return "tma_wgmma_cl"
        if layout == DHWC and c % 4 == 0:
            return "halo_mma"
        if layout == DHCW and w_extent % 8 == 0:
            return "tma_wgmma"
    return "plain"


def library_design(dtype: torch.dtype, layout: int, w_extent: int, c: int) -> str:
    """`wft_conv3_design` of the built library (the rule that `design`
    restates); needs nvcc."""
    fn = _build.LIBRARIES.get("conv3").wft_conv3_design
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    return DESIGNS[fn(_DTYPES[dtype], layout, w_extent, c)]


def _check_block_h(h: int, block_h: int) -> None:
    if h % block_h != 0:
        raise ValueError(f"H={h} must be divisible by block_h={block_h}")


def launch(
    x: torch.Tensor,
    w: torch.Tensor,
    layout: int = DHWC,
    prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    act: bool = False,
    emit_stats: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch `csrc/conv3.cu` on 5-D CUDA `x` ((B, D, H, W, C) for DHWC,
    (B, D, H, C, W) for DHCW) and return (y, stats or None). `prologue` is
    (mean, rstd), each (B, C); stats are (B, 2, O) fp32 [Σ, Σ²] of the fp32
    accumulator. Counts the launch in `design_launches`; each public wrapper
    counts its own calls in `launches`."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3 kernel takes fp32/bf16, got {x.dtype}")
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("conv3: inputs must be CUDA tensors")
    if x.dim() != 5:
        raise ValueError(f"conv3: expected a 5-D input, got {tuple(x.shape)}")
    if layout == DHWC:
        b, d, h, wd, c = x.shape
    else:
        b, d, h, c, wd = x.shape
    if w.shape[:4] != (3, 3, 3, c) or w.dim() != 5:
        raise ValueError(f"conv3: weights {tuple(w.shape)} != (3, 3, 3, {c}, O)")
    o = w.shape[-1]
    x = _build.aligned16(x)
    name = design(x.dtype, layout, wd, c)
    if name in ("tma_wgmma", "tma_wgmma_cl"):
        wk = pack_taps(w.to(x.dtype))
    else:  # (O rounded up to 64, 27·C rounded up to 8), k = tap·C + c, zero-padded
        wk = torch.zeros((-(-o // 64) * 64, -(-27 * c // 8) * 8), dtype=x.dtype, device=x.device)
        wk[:o, : 27 * c] = w.permute(4, 0, 1, 2, 3).reshape(o, 27 * c)
    out_shape = (b, d, h, wd, o) if layout == DHWC else (b, d, h, o, wd)
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    mean = rstd = partial = stats = None
    if prologue is not None:
        mean, rstd = (t.to(torch.float32).expand(b, c).contiguous() for t in prologue)
    lib = _build.LIBRARIES.get("conv3")
    if emit_stats:
        lib.wft_conv3_tiles.restype = ctypes.c_longlong
        lib.wft_conv3_tiles.argtypes = [ctypes.c_int] * 7
        tiles = lib.wft_conv3_tiles(_DTYPES[x.dtype], layout, d, h, wd, c, o)
        partial = torch.empty(b * 2 * o * tiles, dtype=torch.float32, device=x.device)
        stats = torch.empty((b, 2, o), dtype=torch.float32, device=x.device)
    fn = lib.wft_conv3
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(
        _DTYPES[x.dtype], layout, x.data_ptr(), wk.data_ptr(), ptr(mean), ptr(rstd),
        int(act), y.data_ptr(), ptr(partial), ptr(stats), b, d, h, wd, c, o,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"conv3 launch ({name})")
    design_launches[name] += 1
    return y, stats


def _run(name: str, x: torch.Tensor, w: torch.Tensor, layout: int) -> torch.Tensor:
    """One launch of a 5-D input, counted under `name`."""
    y, _ = launch(x, w, layout)
    launches[name] += 1
    return y


def conv3x3x3_same(x: torch.Tensor, w: torch.Tensor, block_h: int = 8) -> torch.Tensor:
    """'SAME' 3³ conv: (D, H, W, C) × (3, 3, 3, C, O) → (D, H, W, O)."""
    _check_block_h(x.shape[1], block_h)
    if x.device.type == "cpu":
        return conv3x3x3_reference(x, w)
    return _run("conv3x3x3_same", x[None], w, DHWC)[0]


def conv3x3x3_batched(x: torch.Tensor, w: torch.Tensor, block_h: int = 8) -> torch.Tensor:
    """(B, D, H, W, C) → (B, D, H, W, O), the whole batch in one launch."""
    _check_block_h(x.shape[2], block_h)
    if x.device.type == "cpu":
        return conv3x3x3_reference(x, w)
    return _run("conv3x3x3_batched", x, w, DHWC)


def conv3x3x3_cw_reference(x_cw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version in the (…, D, H, C, W) layout."""
    return conv3x3x3_reference(x_cw.transpose(-1, -2), w).transpose(-1, -2).contiguous()


def conv3x3x3_cw(x_cw: torch.Tensor, w: torch.Tensor, block_h: int = 8) -> torch.Tensor:
    """'SAME' conv in the channels-before-W layout: (D, H, C, W) ×
    (3, 3, 3, C, O) → (D, H, O, W); (B, D, H, C, W) in one launch."""
    _check_block_h(x_cw.shape[-3], block_h)
    if x_cw.device.type == "cpu":
        return conv3x3x3_cw_reference(x_cw, w)
    single = x_cw.dim() == 4
    y = _run("conv3x3x3_cw", x_cw[None] if single else x_cw, w, DHCW)
    return y[0] if single else y


def conv3x3x3_same_v2(x: torch.Tensor, w: torch.Tensor, block_h: int = 8) -> torch.Tensor:
    """(D, H, W, C) (or (B, D, H, W, C)) through the (D, H, C, W) kernel,
    transposing at the boundary as the JAX wrapper does."""
    _check_block_h(x.shape[-3], block_h)
    x_cw = x.transpose(-1, -2)
    if x.device.type == "cpu":
        return conv3x3x3_cw_reference(x_cw, w).transpose(-1, -2)
    single = x.dim() == 4
    y = _run("conv3x3x3_same_v2", x_cw[None] if single else x_cw, w, DHCW)
    y = y.transpose(-1, -2)
    return y[0] if single else y
