"""3D Haar discrete wavelet transform (`db1`, pywt `mode='zero'`).

Port of `waveformer_tpu/ops/wavelet.py` for the Haar wavelet, the only one
the WaveFormer family uses. Subband keys follow the pywt `dwtn`
convention: character i selects approximation `a` / detail `d` along
spatial axis i, in (D, H, W) order. Odd extents are zero-padded by one, as
pywt's zero mode does (`(N + 1) // 2` outputs per level). Any other wavelet
raises `ValueError`.

The default `axes=(1, 2, 3)` is the channels-last (B, D, H, W, C) layout
the model uses; pass `axes=(2, 3, 4)` for NCDHW.
"""

from __future__ import annotations

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
    return (x0 + x1) * _INV_SQRT2, (x0 - x1) * _INV_SQRT2


def _haar_merge(a: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of `_haar_split` (output length 2·N along `axis`)."""
    x0 = (a + d) * _INV_SQRT2
    x1 = (a - d) * _INV_SQRT2
    stacked = torch.stack([x0, x1], dim=axis + 1)
    shape = list(a.shape)
    shape[axis] = a.shape[axis] * 2
    return stacked.reshape(shape)


def dwt3(
    x: torch.Tensor, wavelet: str = "db1", axes: Sequence[int] = (1, 2, 3)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-level 3D DWT → `(lowpass, {key: detail})` over `DETAIL_KEYS`."""
    _check_wavelet(wavelet)
    ax_d, ax_h, ax_w = axes
    a, d = _haar_split(x, ax_d)
    aa, ad = _haar_split(a, ax_h)
    da, dd = _haar_split(d, ax_h)
    aaa, aad = _haar_split(aa, ax_w)
    ada, add = _haar_split(ad, ax_w)
    daa, dad = _haar_split(da, ax_w)
    dda, ddd = _haar_split(dd, ax_w)
    return aaa, {
        "aad": aad,
        "ada": ada,
        "add": add,
        "daa": daa,
        "dad": dad,
        "dda": dda,
        "ddd": ddd,
    }


def idwt3(
    lowpass: torch.Tensor,
    details: Dict[str, torch.Tensor],
    wavelet: str = "db1",
    axes: Sequence[int] = (1, 2, 3),
) -> torch.Tensor:
    """Single-level 3D inverse DWT (inverse of `dwt3`)."""
    _check_wavelet(wavelet)
    ax_d, ax_h, ax_w = axes
    aa = _haar_merge(lowpass, details["aad"], ax_w)
    ad = _haar_merge(details["ada"], details["add"], ax_w)
    da = _haar_merge(details["daa"], details["dad"], ax_w)
    dd = _haar_merge(details["dda"], details["ddd"], ax_w)
    a = _haar_merge(aa, ad, ax_h)
    d = _haar_merge(da, dd, ax_h)
    return _haar_merge(a, d, ax_d)


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
