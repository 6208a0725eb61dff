"""3D discrete wavelet transform: the Haar cascade and a generic FIR path.

Port of `waveformer_tpu/ops/wavelet.py`. Subband keys follow the pywt
`dwtn` convention: character i selects approximation `a` / detail `d` along
spatial axis i, in (D, H, W) order. `db1`/`haar` (the only wavelet the
WaveFormer family uses) runs the Haar cascade; every other name registered
with `register_wavelet` runs the generic separable path on `F.conv1d`, as
the JAX op runs it on `lax.conv`; an unregistered name raises `ValueError`.

Haar: odd extents are zero-padded by one, as pywt's zero mode does
(`(N + 1) // 2` outputs per level). The default `axes=(1, 2, 3)` is the
channels-last (B, D, H, W, C) layout the model uses; pass `axes=(2, 3, 4)`
for NCDHW. Both run one per-axis cascade, in the JAX op's order for the
input: for 5-D input at `axes=(1, 2, 3)` the JAX phase path's (analysis W,
H, D; synthesis D, H, W), else the JAX cascade's (D, H, W; W, H, D). Each
step multiplies by 1/√2 rounded to the input's dtype, so the result is
bit-equal to the JAX op in fp32 and bf16; the two orders agree with each
other only to rounding.

Generic path: analysis pads L − 1 zeros a side, correlates with the
reversed filter at stride 2 from index L − 1 and keeps (N + L − 1) // 2
samples; synthesis upsamples by 2, correlates with the reversed filter and
keeps 2n samples from index L − 2 (pywt's length is 2n − L + 2; `waverec3`
trims). The filters are cast to the input's dtype. The JAX analysis yields
only (N − 1) // 2 + 1 samples per axis, too few for banks of 3 taps at an
even extent and of 4 or more at any extent, where it fails; the port raises
`ValueError` there before any work.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DETAIL_KEYS: Tuple[str, ...] = ("aad", "ada", "add", "daa", "dad", "dda", "ddd")

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


_WAVELETS: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = {}


def register_wavelet(name: str, dec_lo, dec_hi, rec_lo, rec_hi) -> None:
    """Register an FIR wavelet filter bank (pywt coefficient convention)
    for the generic path."""
    _WAVELETS[name] = tuple(
        np.asarray(f, dtype=np.float64) for f in (dec_lo, dec_hi, rec_lo, rec_hi)
    )


register_wavelet(
    "db1",
    dec_lo=[_INV_SQRT2, _INV_SQRT2],
    dec_hi=[-_INV_SQRT2, _INV_SQRT2],
    rec_lo=[_INV_SQRT2, _INV_SQRT2],
    rec_hi=[_INV_SQRT2, -_INV_SQRT2],
)
_WAVELETS["haar"] = _WAVELETS["db1"]


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
    if wavelet not in ("db1", "haar"):
        return _dwt3_generic(x, wavelet, axes)
    return _dwt3_cascade(x, axes, _jax_order(x.ndim, axes))


def idwt3(
    lowpass: torch.Tensor,
    details: Dict[str, torch.Tensor],
    wavelet: str = "db1",
    axes: Sequence[int] = (1, 2, 3),
) -> torch.Tensor:
    """Single-level 3D inverse DWT (inverse of `dwt3`)."""
    if wavelet not in ("db1", "haar"):
        return _idwt3_generic(lowpass, details, wavelet, axes)
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


# --------------------------------------------------------------------------- #
# generic separable FIR path (registered wavelets other than db1/haar)
# --------------------------------------------------------------------------- #


def _filter(f: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The reversed filter as a (1, 1, L) conv weight in `like`'s dtype."""
    return torch.tensor(f[::-1].copy(), dtype=like.dtype, device=like.device).reshape(1, 1, -1)


def _dwt1d_generic(x, dec_lo, dec_hi, axis):
    """1D analysis along `axis`: zero padding, the reversed filters at
    stride 2 from index L − 1, (N + L − 1) // 2 samples kept."""
    flen = dec_lo.shape[0]
    pad = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [flen - 1, flen - 1]
    xp = torch.movedim(F.pad(x, pad), axis, -1)
    lead = xp.shape[:-1]
    flat = xp.reshape(-1, 1, xp.shape[-1])[:, :, flen - 1:]
    out_len = (x.shape[axis] + flen - 1) // 2
    lo = F.conv1d(flat, _filter(dec_lo, x), stride=2)[:, 0, :out_len]
    hi = F.conv1d(flat, _filter(dec_hi, x), stride=2)[:, 0, :out_len]
    return (torch.movedim(lo.reshape(*lead, out_len), -1, axis),
            torch.movedim(hi.reshape(*lead, out_len), -1, axis))


def _idwt1d_generic(a, d, rec_lo, rec_hi, axis, out_len):
    """1D synthesis along `axis`: upsample by 2, the reversed filters with
    L − 1 zeros a side, `out_len` samples kept from index L − 2."""
    flen = rec_lo.shape[0]
    a = torch.movedim(a, axis, -1)
    d = torch.movedim(d, axis, -1)
    lead = a.shape[:-1]
    n = a.shape[-1]
    up_a = a.new_zeros(*lead, 2 * n)
    up_d = a.new_zeros(*lead, 2 * n)
    up_a[..., ::2] = a
    up_d[..., ::2] = d
    y = (F.conv1d(up_a.reshape(-1, 1, 2 * n), _filter(rec_lo, a), padding=flen - 1)[:, 0]
         + F.conv1d(up_d.reshape(-1, 1, 2 * n), _filter(rec_hi, a), padding=flen - 1)[:, 0])
    trim = max(flen - 2, 0)
    y = y[:, trim:trim + out_len].reshape(*lead, out_len)
    return torch.movedim(y, -1, axis)


def _bank(wavelet: str):
    if wavelet not in _WAVELETS:
        raise ValueError(f"unknown wavelet {wavelet!r}; register it first")
    return _WAVELETS[wavelet]


def _check_analysis(x: torch.Tensor, wavelet: str, dec_lo, dec_hi, axes) -> None:
    """Raise where the JAX analysis fails: its stride-2 conv yields (N − 1)
    // 2 + 1 samples along an axis of extent N, and it keeps (N + L − 1) //
    2 of them."""
    flen = dec_lo.shape[0]
    if dec_hi.shape[0] != flen:
        raise ValueError(f"wavelet {wavelet!r}: dec_lo and dec_hi differ in length "
                         f"({flen} != {dec_hi.shape[0]})")
    for ax in axes:
        n = x.shape[ax]
        if (n - 1) // 2 + 1 < (n + flen - 1) // 2:
            raise ValueError(
                f"wavelet {wavelet!r}: the generic path takes filter banks of at most 2 "
                f"taps (3 at an odd extent); its {flen}-tap bank at extent {n} would need "
                f"{(n + flen - 1) // 2} samples where the stride-2 filter gives "
                f"{(n - 1) // 2 + 1}")


def _dwt3_generic(x, wavelet, axes):
    dec_lo, dec_hi, _, _ = _bank(wavelet)
    _check_analysis(x, wavelet, dec_lo, dec_hi, axes)
    ax_d, ax_h, ax_w = axes
    a, d = _dwt1d_generic(x, dec_lo, dec_hi, ax_d)
    aa, ad = _dwt1d_generic(a, dec_lo, dec_hi, ax_h)
    da, dd = _dwt1d_generic(d, dec_lo, dec_hi, ax_h)
    aaa, aad = _dwt1d_generic(aa, dec_lo, dec_hi, ax_w)
    ada, add = _dwt1d_generic(ad, dec_lo, dec_hi, ax_w)
    daa, dad = _dwt1d_generic(da, dec_lo, dec_hi, ax_w)
    dda, ddd = _dwt1d_generic(dd, dec_lo, dec_hi, ax_w)
    return aaa, {"aad": aad, "ada": ada, "add": add, "daa": daa, "dad": dad, "dda": dda,
                 "ddd": ddd}


def _idwt3_generic(lowpass, details, wavelet, axes):
    """Synthesis W, H, then D; each axis's output is 2n long, n the
    extent of the subbands along it."""
    _, _, rec_lo, rec_hi = _bank(wavelet)
    ax_d, ax_h, ax_w = axes
    aad = details["aad"]

    def merge(a, d, ax):
        return _idwt1d_generic(a, d, rec_lo, rec_hi, ax, 2 * aad.shape[ax])

    aa = merge(lowpass, aad, ax_w)
    ad = merge(details["ada"], details["add"], ax_w)
    da = merge(details["daa"], details["dad"], ax_w)
    dd = merge(details["dda"], details["ddd"], ax_w)
    return merge(merge(aa, ad, ax_h), merge(da, dd, ax_h), ax_d)
