"""Tiled bf16 → fp32 and int8 → int32 matrix product: CUDA kernel wrapper and plain version.

Port of `tools/exp_int8_mxu.py::make`, the Pallas product of the int8
probe. The kernels are in `csrc/tiled_matmul.cu` (see its header for the
designs, both on TMA + `wgmma`: bf16 `tma_wgmma`; int8 `tma_wgmma_s8`, which
first transposes w into a K-major scratch with `w_kmajor_kernel`, since
8-bit `wgmma` reads both operands K-major). For x (M, K), w (K, N) and s
(8,) fp32:

    bf16 → fp32,  perturb_out=False: out = (x ⊕ bf16(s[0])) @ w   (the probe's bf16 run)
    bf16 → fp32,  perturb_out=True:  out = x @ w + s[0]
    int8 → int32, perturb_out=True:  out = x @ w + int32(s[0])    (the probe's int8 run)
    int8 → int32, perturb_out=False: out = (x ⊕ int8(s[0])) @ w

⊕ adds per element in the input type, rounded to bf16 or wrapping in int8;
a cast of s[0] to an integer truncates toward zero. s stays on the device.

On CPU tensors `tiled_matmul` runs `tiled_matmul_reference`; on CUDA
tensors it launches the kernel or raises. No library product is on its path.
"""

from __future__ import annotations

import ctypes

import torch

from waveformer_tpu_torch.ops import _build

# input dtype → (kernel name, output dtype)
PAIRS = {torch.bfloat16: ("tiled_matmul_bf16", torch.float32),
         torch.int8: ("tiled_matmul_int8", torch.int32)}

# per-launch counters, read by chip_smoke.py to prove the probe ran here:
# each product, and `w_kmajor`, the transpose every int8 product launches first
launches = {"tiled_matmul_bf16": 0, "tiled_matmul_int8": 0, "w_kmajor": 0}
# the kernel's designs, by the number `wft_tiled_matmul_design` returns (one
# per input type, so `launches` counts each design's launches)
DESIGNS = ("tma_wgmma", "tma_wgmma_s8")


def _fn(name: str, *argtypes):
    """The library's C entry `name`, its types set once per loaded library
    (the host work of a call counts: at the probe's shapes it is close to the
    kernels' own time)."""
    fn = getattr(_build.LIBRARIES.get("tiled_matmul"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


def design(dtype: torch.dtype) -> str:
    """The design `csrc/tiled_matmul.cu` launches for this input type (bf16
    `tma_wgmma`, int8 `tma_wgmma_s8`); needs the built library."""
    fn = _fn("wft_tiled_matmul_design", ctypes.c_int)
    return DESIGNS[fn(int(dtype == torch.int8))]


def supported(k: int, n: int, dtype: torch.dtype) -> bool:
    """Shapes the kernel takes: x rows of whole 16-byte vectors (K % 8 == 0
    for bf16, K % 16 == 0 for int8) and N % 8 == 0."""
    if dtype not in PAIRS:
        return False
    return k > 0 and n > 0 and k % (16 // dtype.itemsize) == 0 and n % 8 == 0


def _check(s: torch.Tensor, x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> None:
    if x.dtype not in PAIRS or w.dtype != x.dtype or PAIRS[x.dtype][1] != out_dtype:
        raise ValueError(
            f"tiled_matmul takes (bf16, bf16) → fp32 or (int8, int8) → int32, got "
            f"({x.dtype}, {w.dtype}) → {out_dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"tiled_matmul: x {tuple(x.shape)} and w {tuple(w.shape)} do not chain")
    if tuple(s.shape) != (8,) or s.dtype != torch.float32:
        raise ValueError(f"tiled_matmul: s must be (8,) fp32, got {tuple(s.shape)} {s.dtype}")
    k, n = w.shape
    if not supported(k, n, x.dtype):
        raise ValueError(f"tiled_matmul kernel does not take K={k}, N={n} in {x.dtype}")


def tiled_matmul_reference(s, x, w, *, out_dtype, perturb_out: bool) -> torch.Tensor:
    """The plain version: bf16 in fp32 (TF32 off), int8 through float64
    products, which are exact while 128²·K < 2^53."""
    s0 = s[0]
    if x.dtype == torch.bfloat16:
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            if perturb_out:
                return x.float() @ w.float() + s0
            xs = (x.float() + s0.to(torch.bfloat16).float()).to(torch.bfloat16)
            return xs.float() @ w.float()
        finally:
            torch.set_float32_matmul_precision(prev)
    si = s0.to(torch.int32)  # truncates toward zero
    if perturb_out:
        return (x.double() @ w.double()).to(torch.int32) + si
    xs = (x.to(torch.int32) + si).to(torch.int8)  # wraps in two's complement
    return (xs.double() @ w.double()).to(torch.int32)


def w_kmajor(w: torch.Tensor) -> torch.Tensor:
    """wᵀ (N, K) of an int8 w (K, N), contiguous: the K-major operand of the
    int8 product, which launches the same kernel itself into a fresh scratch
    on every call (nothing is cached across calls). On the CPU the plain
    version, on the card `w_kmajor_kernel` alone."""
    if w.dtype != torch.int8 or w.dim() != 2:
        raise ValueError(f"w_kmajor takes a 2-D int8 w, got {tuple(w.shape)} {w.dtype}")
    k, n = w.shape
    if not supported(k, n, torch.int8):
        raise ValueError(f"w_kmajor kernel does not take K={k}, N={n}")
    if w.device.type == "cpu":
        return w_kmajor_reference(w)
    w = _build.aligned16(w)
    wt = torch.empty((n, k), dtype=torch.int8, device=w.device)
    fn = _fn("wft_w_kmajor", *[ctypes.c_void_p] * 2, *[ctypes.c_int] * 2, ctypes.c_void_p)
    err = fn(w.data_ptr(), wt.data_ptr(), k, n, torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "w_kmajor launch")
    launches["w_kmajor"] += 1
    return wt


def w_kmajor_reference(w: torch.Tensor) -> torch.Tensor:
    """The plain version of `w_kmajor`."""
    return w.t().contiguous()


def _launch(s, x, w, out_dtype, perturb_out: bool) -> torch.Tensor:
    if not (s.is_cuda and x.is_cuda and w.is_cuda) or not (
            s.device == x.device == w.device):
        raise ValueError("tiled_matmul: s, x and w must be CUDA tensors on one device")
    name = PAIRS[x.dtype][0]
    int8 = x.dtype == torch.int8
    s, x, w = s.contiguous(), _build.aligned16(x), _build.aligned16(w)
    m, k = x.shape
    n = w.shape[1]
    # int8: the C call launches `w_kmajor` into this scratch, then the product
    wt = torch.empty((n, k), dtype=torch.int8, device=x.device) if int8 else None
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    fn = _fn("wft_tiled_matmul", ctypes.c_int, *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 4,
             ctypes.c_void_p)
    err = fn(int(int8), s.data_ptr(), x.data_ptr(), w.data_ptr(),
             wt.data_ptr() if int8 else None, out.data_ptr(), m, k, n, int(perturb_out),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"{name} launch")
    launches[name] += 1
    if int8:
        launches["w_kmajor"] += 1
    return out


def tiled_matmul(s, x, w, *, out_dtype, perturb_out: bool) -> torch.Tensor:
    """`out` of the module docstring for x (M, K), w (K, N), s (8,) fp32."""
    _check(s, x, w, out_dtype)
    if x.device.type == "cpu":
        return tiled_matmul_reference(s, x, w, out_dtype=out_dtype, perturb_out=perturb_out)
    return _launch(s, x, w, out_dtype, perturb_out)


def make(M: int, K: int, N: int, BM: int, out_dtype: torch.dtype, perturb_out: bool):
    """The JAX `make`: `mm(s, x, w)` for x (M, K), w (K, N), s (8,) fp32.

    The JAX grid `M // BM` leaves the last `M % BM` rows unwritten; here such
    an M is refused. BM sets nothing else: the kernel picks its own tile.
    """
    in_dtype = next((d for d, (_, o) in PAIRS.items() if o == out_dtype), None)
    if in_dtype is None:
        raise ValueError(f"make: out_dtype must be torch.float32 or torch.int32, got {out_dtype}")
    if BM < 1 or M < 1 or M % BM:
        raise ValueError(f"make: M={M} is not a whole number of BM={BM} row blocks")
    if not supported(K, N, in_dtype):
        raise ValueError(f"make: the kernel does not take K={K}, N={N} in {in_dtype}")

    def mm(s, x, w):
        if tuple(x.shape) != (M, K) or tuple(w.shape) != (K, N):
            raise ValueError(
                f"mm: x {tuple(x.shape)}, w {tuple(w.shape)}; made for ({M}, {K}), ({K}, {N})")
        return tiled_matmul(s, x, w, out_dtype=out_dtype, perturb_out=perturb_out)

    return mm
