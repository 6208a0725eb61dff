"""Grid pull/push resampling with B-spline orders 0-3, and the prefilter.

Port of `waveformer_tpu/ops/spatial.py` (the JAX package's answer to
MONAI's `resample/pushpull` extension). `grid_pull` samples a channels-last
volume (D, H, W, C) at (N, 3) coordinates; `grid_push` is its adjoint, a
scatter-add; `grid_count` pushes unit weights. The volume holds spline
coefficients: for orders ≥ 2, `spline_prefilter` turns samples into
coefficients so that a pull interpolates (scipy's `map_coordinates(...,
prefilter=False)` after `spline_filter`).

Every op is a loop over the (order_z + 1)·(order_y + 1)·(order_x + 1) taps
of a separable stencil, each tap one gather (pull) or one `index_add_`
(push) over all N points on the tensors' own device. Sums are fp32: a pull
returns the volume's dtype, a push or count fp32.

Bounds (ours ↔ scipy.ndimage): zero ↔ 'constant' (the index is clipped and
its weight masked), clamp ↔ 'nearest', reflect ↔ 'mirror' (a floor-modulo
over the period 2n − 2). Orders 0 and 2 centre on floor(x + 0.5), which
rounds halves up.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple, Union

import numpy as np
import torch

BOUND_MODES = ("zero", "clamp", "reflect")
MAX_ORDER = 3

BoundArg = Union[str, Sequence[str]]
OrderArg = Union[int, Sequence[int]]


def _apply_bound(idx: torch.Tensor, n: int, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map integer indices into range; returns (index, fp32 weight mask)."""
    if mode == "zero":
        valid = (idx >= 0) & (idx < n)
        return idx.clamp(0, n - 1), valid.float()
    if mode == "clamp":
        return idx.clamp(0, n - 1), torch.ones_like(idx, dtype=torch.float32)
    if mode == "reflect":
        period = max(2 * n - 2, 1)
        r = torch.remainder(idx, period)
        r = torch.where(r >= n, period - r, r)
        return r, torch.ones_like(idx, dtype=torch.float32)
    raise ValueError(f"unknown bound mode {mode!r}")


def _per_dim(arg, what, allowed=None) -> Tuple:
    """Broadcast a scalar-or-3-sequence argument to a 3-tuple."""
    if isinstance(arg, (str, int)):
        arg = (arg,) * 3
    arg = tuple(arg)
    if len(arg) != 3:
        raise ValueError(f"{what} must be scalar or length-3, got {arg!r}")
    if allowed is not None:
        for a in arg:
            if a not in allowed:
                raise ValueError(f"unknown {what} {a!r} (allowed: {allowed})")
    return arg


def _spline_taps(x: torch.Tensor, order: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """1-D B-spline stencil: (integer index, fp32 weight) per support node,
    the order-`order` cardinal B-spline at the distance to each node."""
    if order == 0:
        i = torch.floor(x + 0.5).to(torch.int32)
        return [(i, torch.ones_like(x, dtype=torch.float32))]
    if order == 1:
        i0 = torch.floor(x).to(torch.int32)
        t = (x - i0).float()
        return [(i0, 1.0 - t), (i0 + 1, t)]
    if order == 2:
        # nodes at the 3 integers around round(x); t ∈ [-0.5, 0.5]
        i = torch.floor(x + 0.5).to(torch.int32)
        t = (x - i).float()
        return [
            (i - 1, 0.5 * (0.5 - t) ** 2),
            (i, 0.75 - t * t),
            (i + 1, 0.5 * (0.5 + t) ** 2),
        ]
    if order == 3:
        i = torch.floor(x).to(torch.int32)
        t = (x - i).float()
        t2, t3 = t * t, t * t * t
        return [
            (i - 1, (1.0 - t) ** 3 / 6.0),
            (i, (3.0 * t3 - 6.0 * t2 + 4.0) / 6.0),
            (i + 1, (-3.0 * t3 + 3.0 * t2 + 3.0 * t + 1.0) / 6.0),
            (i + 2, t3 / 6.0),
        ]
    raise ValueError(f"spline order must be 0..{MAX_ORDER}, got {order}")


def _stencil_terms(coords: torch.Tensor, shape: Tuple[int, int, int],
                   bound: Tuple[str, str, str], order: Tuple[int, int, int]
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Separable 3-D stencil: ((N,) int64 flat index, (N,) fp32 weight) per
    tap, made one tap at a time."""
    d, h, w = shape
    taps_z = _spline_taps(coords[:, 0], order[0])
    taps_y = _spline_taps(coords[:, 1], order[1])
    taps_x = _spline_taps(coords[:, 2], order[2])
    for rz, wz in taps_z:
        iz, mz = _apply_bound(rz, d, bound[0])
        for ry, wy in taps_y:
            iy, my = _apply_bound(ry, h, bound[1])
            for rx, wx in taps_x:
                ix, mx = _apply_bound(rx, w, bound[2])
                weight = (wz * wy * wx * mz * my * mx).float()
                flat = ((iz * h + iy) * w + ix).long()
                yield flat, weight


def _pull_impl(volume, coords, bound, order):
    bound = _per_dim(bound, "bound mode", BOUND_MODES)
    order = _per_dim(order, "spline order", tuple(range(MAX_ORDER + 1)))
    d, h, w, c = volume.shape
    flat_vol = volume.reshape(-1, c).float()
    out = torch.zeros(coords.shape[0], c, dtype=torch.float32, device=volume.device)
    for flat, weight in _stencil_terms(coords, (d, h, w), bound, order):
        out = out + weight[:, None] * flat_vol[flat]
    return out.to(volume.dtype)


def _push_impl(values, coords, shape, bound, order):
    bound = _per_dim(bound, "bound mode", BOUND_MODES)
    order = _per_dim(order, "spline order", tuple(range(MAX_ORDER + 1)))
    d, h, w = shape
    c = values.shape[-1]
    out = torch.zeros(d * h * w, c, dtype=torch.float32, device=values.device)
    v32 = values.float()
    for flat, weight in _stencil_terms(coords, (d, h, w), bound, order):
        out.index_add_(0, flat, weight[:, None] * v32)
    return out.reshape(d, h, w, c)


class _GridPull(torch.autograd.Function):
    """Pull with JAX's `custom_vjp`: the volume's gradient is a push of the
    cotangent through the same weights (in the volume's dtype), the
    coordinates' gradient the derivative of the stencil weights."""

    @staticmethod
    def forward(ctx, volume, coords, bound, order):
        ctx.save_for_backward(volume, coords)
        ctx.bound, ctx.order = bound, order
        return _pull_impl(volume, coords, bound, order)

    @staticmethod
    def backward(ctx, g):
        volume, coords = ctx.saved_tensors
        dvol = dcoords = None
        if ctx.needs_input_grad[0]:
            dvol = _push_impl(g, coords, volume.shape[:3], ctx.bound, ctx.order).to(volume.dtype)
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                crd = coords.detach().requires_grad_(True)
                out = _pull_impl(volume.detach(), crd, ctx.bound, ctx.order)
                (dcoords,) = torch.autograd.grad(out, crd, g)
        return dvol, dcoords, None, None


def grid_pull(volume: torch.Tensor, coords: torch.Tensor,
              bound: BoundArg = "zero", order: OrderArg = 1) -> torch.Tensor:
    """Sample `volume` (D, H, W, C) at `coords` (N, 3) → (N, C).

    `bound` and `order` take one value or one per spatial dim."""
    return _GridPull.apply(volume, coords, bound, order)


def grid_push(values: torch.Tensor, coords: torch.Tensor, shape: Tuple[int, int, int],
              bound: BoundArg = "zero", order: OrderArg = 1) -> torch.Tensor:
    """Splat `values` (N, C) at `coords` (N, 3) into an fp32 (D, H, W, C)
    volume: the adjoint of `grid_pull` at the same bound and order."""
    return _push_impl(values, coords, shape, bound, order)


def grid_count(coords: torch.Tensor, shape: Tuple[int, int, int],
               bound: BoundArg = "zero", order: OrderArg = 1) -> torch.Tensor:
    """Splat unit weights: the (D, H, W) fp32 count."""
    ones = torch.ones(coords.shape[0], 1, dtype=torch.float32, device=coords.device)
    return _push_impl(ones, coords, shape, bound, order)[..., 0]


# poles of the recursive B-spline filter by order
_POLES = {0: (), 1: (), 2: (2.0 ** 0.5 * 2.0 - 3.0,), 3: (3.0 ** 0.5 - 2.0,)}


def spline_prefilter(volume: torch.Tensor, order: OrderArg = 3,
                     bound: BoundArg = "reflect") -> torch.Tensor:
    """B-spline coefficients of `volume` (D, H, W, C) so that `grid_pull` of
    them interpolates it (scipy's `spline_filter`, mirror boundary, per
    axis). `bound` is accepted and ignored, as in the JAX op: the filter's
    boundary is always the mirror."""
    order_t = _per_dim(order, "spline order", tuple(range(MAX_ORDER + 1)))
    out = volume.float()
    for axis, k in enumerate(order_t):
        for pole in _POLES[k]:
            out = _filter_axis(out, axis, pole)
    return out.to(volume.dtype)


def _horizon(n: int, z: float) -> int:
    """Terms of the causal start's geometric sum: min(n, ceil(−30 /
    log10|z|)), reckoned in fp32 as the JAX op does."""
    if abs(z) == 0:
        return n
    return min(n, int(np.ceil(np.float32(-30.0) / np.log10(np.float32(abs(z))))))


def _filter_axis(x: torch.Tensor, axis: int, z: float) -> torch.Tensor:
    """One pole of the recursive filter along `axis` (Unser 1993): a causal
    then an anti-causal recursion, each a loop over whole planes."""
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    gain = (1.0 - z) * (1.0 - 1.0 / z)
    xg = x * gain
    horizon = _horizon(n, z)
    powers = z ** torch.arange(horizon, dtype=torch.float32, device=x.device)
    c = torch.tensordot(powers, xg[:horizon], dims=([0], [0]))
    cplus = [c]
    for i in range(1, n):
        c = xg[i] + z * c
        cplus.append(c)
    # anti-causal start (mirror): c-[n-1] = z/(z²−1)·(c+[n−1] + z·c+[n−2])
    c = (z / (z * z - 1.0)) * (cplus[-1] + z * cplus[-2])
    cminus = [c]
    for i in range(n - 2, -1, -1):
        c = z * (c - cplus[i])
        cminus.append(c)
    return torch.movedim(torch.stack(cminus[::-1]), 0, axis)

