"""3D Haar discrete wavelet transform (`db1`, pywt `mode='zero'`).

Port of `waveformer_tpu/ops/wavelet.py` for the Haar wavelet, the only one
the WaveFormer family uses. Subband keys follow the pywt `dwtn`
convention: character i selects approximation `a` / detail `d` along
spatial axis i, in (D, H, W) order. Odd extents are zero-padded by one, as
pywt's zero mode does (`(N + 1) // 2` outputs per level). Any other wavelet
raises `ValueError`.

The default `axes=(1, 2, 3)` is the channels-last (B, D, H, W, C) layout
the model uses; pass `axes=(2, 3, 4)` for NCDHW. Both run one per-axis
cascade, in the JAX op's order for the input: for 5-D input at
`axes=(1, 2, 3)` the JAX phase path's (analysis W, H, D; synthesis D, H,
W), else the JAX cascade's (D, H, W; W, H, D). Each step multiplies by
1/√2 rounded to the input's dtype, so the result is bit-equal to the JAX
op in fp32 and bf16; the two orders agree with each other only to
rounding.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch

DETAIL_KEYS: Tuple[str, ...] = ("aad", "ada", "add", "daa", "dad", "dda", "ddd")

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _check_wavelet(wavelet: str) -> None:
    if wavelet not in ("db1", "haar"):
        raise ValueError(
            f"wavelet {wavelet!r} is not supported: only Haar ('db1'/'haar')"
        )


def _haar_split(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """a[k] = (x[2k] + x[2k+1])/√2, d[k] = (x[2k] − x[2k+1])/√2; for odd N
    the last sample pairs with an implicit zero."""
    if x.shape[axis] % 2 == 1:
        pad_shape = list(x.shape)
        pad_shape[axis] = 1
        x = torch.cat([x, x.new_zeros(pad_shape)], dim=axis)
    even = [slice(None)] * x.ndim
    odd = [slice(None)] * x.ndim
    even[axis] = slice(0, None, 2)
    odd[axis] = slice(1, None, 2)
    x0 = x[tuple(even)]
    x1 = x[tuple(odd)]
    s = _scale(x.dtype)
    return (x0 + x1) * s, (x0 - x1) * s


def _haar_merge(a: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of `_haar_split` (output length 2·N along `axis`)."""
    s = _scale(a.dtype)
    x0 = (a + d) * s
    x1 = (a - d) * s
    stacked = torch.stack([x0, x1], dim=axis + 1)
    shape = list(a.shape)
    shape[axis] = a.shape[axis] * 2
    return stacked.reshape(shape)


@functools.lru_cache(maxsize=None)
def _scale(dtype: torch.dtype) -> float:
    """1/√2 rounded to `dtype` (0.70703125 in bf16), as the JAX ops take it.
    A Python float: the product with it rounds once, as JAX's product of two
    values of the dtype does, and a device tensor made per call would copy
    from the host and wait for the stream."""
    return float(torch.tensor(_INV_SQRT2, dtype=dtype))


def _dwt3_cascade(
    x: torch.Tensor, axes: Sequence[int], order: Sequence[int]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Haar analysis one axis at a time, in `order` (positions in `axes`,
    0/1/2 = D/H/W; the key's character at that position names the band)."""
    bands = {"???": x}
    for i in order:
        split = {}
        for key, t in bands.items():
            a, d = _haar_split(t, axes[i])
            split[key[:i] + "a" + key[i + 1:]] = a
            split[key[:i] + "d" + key[i + 1:]] = d
        bands = split
    return bands["aaa"], {k: bands[k] for k in DETAIL_KEYS}


def _idwt3_cascade(
    lowpass: torch.Tensor,
    details: Dict[str, torch.Tensor],
    axes: Sequence[int],
    order: Sequence[int],
) -> torch.Tensor:
    """Haar synthesis one axis at a time, in `order` (as `_dwt3_cascade`)."""
    bands = {"aaa": lowpass, **details}
    for i in order:
        merged = {}
        for key, t in bands.items():
            if key[i] == "a":
                d = bands[key[:i] + "d" + key[i + 1:]]
                merged[key[:i] + "?" + key[i + 1:]] = _haar_merge(t, d, axes[i])
        bands = merged
    return bands["???"]


def _jax_order(ndim: int, axes: Sequence[int]) -> Tuple[int, ...]:
    """The analysis order of the JAX op for this input: W, H, D for 5-D
    input at `axes=(1, 2, 3)` (its phase path), else D, H, W (its cascade).
    Its synthesis runs the reverse."""
    return (2, 1, 0) if ndim == 5 and tuple(axes) == (1, 2, 3) else (0, 1, 2)


def dwt3(
    x: torch.Tensor, wavelet: str = "db1", axes: Sequence[int] = (1, 2, 3)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-level 3D DWT → `(lowpass, {key: detail})` over `DETAIL_KEYS`."""
    _check_wavelet(wavelet)
    return _dwt3_cascade(x, axes, _jax_order(x.ndim, axes))


def idwt3(
    lowpass: torch.Tensor,
    details: Dict[str, torch.Tensor],
    wavelet: str = "db1",
    axes: Sequence[int] = (1, 2, 3),
) -> torch.Tensor:
    """Single-level 3D inverse DWT (inverse of `dwt3`)."""
    _check_wavelet(wavelet)
    order = _jax_order(lowpass.ndim, axes)[::-1]
    return _idwt3_cascade(lowpass, details, axes, order)


def wavedec3(
    x: torch.Tensor,
    wavelet: str = "db1",
    level: int = 1,
    axes: Sequence[int] = (1, 2, 3),
) -> List:
    """Multi-level DWT: `[lowpass_L, details_L, ..., details_1]`, coarsest
    details first (the ptwt layout)."""
    coeffs: List = []
    ll = x
    for _ in range(level):
        ll, det = dwt3(ll, wavelet=wavelet, axes=axes)
        coeffs.append(det)
    coeffs.reverse()
    return [ll] + coeffs


def waverec3(
    coeffs: Sequence, wavelet: str = "db1", axes: Sequence[int] = (1, 2, 3)
) -> torch.Tensor:
    """Multi-level inverse DWT of `[lowpass, details_coarsest, ...]`."""
    x = coeffs[0]
    for det in coeffs[1:]:
        # pywt trims the lowpass when a deeper level was padded to even
        ref = next(iter(det.values()))
        if x.shape != ref.shape:
            sl = [slice(None)] * x.ndim
            for ax in axes:
                sl[ax] = slice(0, ref.shape[ax])
            x = x[tuple(sl)]
        x = idwt3(x, det, wavelet=wavelet, axes=axes)
    return x
