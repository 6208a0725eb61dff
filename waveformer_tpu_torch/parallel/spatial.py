"""The `spatial` mesh axis: the depth D of a volume split over a line of ranks.

Port of what XLA inserts for the JAX package's depth split (`batch_spec`,
`waveformer_tpu/parallel/mesh.py:84-91`). Rank s of a line of S holds
planes [s·Dl, (s+1)·Dl) of every channels-last (B, D, H, W, C) activation,
Dl = D / S, and these functions move what an op needs across the cut:

  * `halo` / `neighbour_planes`: planes of the ranks before and after,
    zeros beyond the volume's first and last plane (SAME padding);
  * `gather_depth` / `own_planes`: the whole D (coarse attention grids whose
    windows straddle the cut, and the logits at the end), and this rank's
    planes of a whole tensor;
  * `instance_norm`, `mean_dhw`: statistics over D·H·W from fp32 sums
    all-reduced over the line, in two passes (Σx, then Σ(x − μ)²) as JAX's
    op takes the mean and then the variance;
  * `conv3_same`: a dense 3³ SAME conv of the slab;
  * `resize_trilinear`: `F.interpolate`'s trilinear resize of this rank's
    output planes, from global source positions.

The rest of a forward is local: 1³ convs, LayerNorms, the k2 s2 patch
embedding and transposed conv, `PatchMerging` and the Haar DWT/IDWT pair or
stride within pairs of planes, which stay on one rank while every rank's
offset and extent are even (`model_parallel.shard_model` checks the
grids). Every collective is an all-reduce of an `AxisShard`, and every
function here is differentiable: a halo's, a gather's and a statistic's
backward sums the ranks' cotangents over the line (`AxisShard.sum`), so a
slab's gradient takes the neighbours' share of its edge planes, a gathered
grid's backward is a reduce-scatter, and a statistic's cotangent is the
whole volume's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from waveformer_tpu_torch.ops import resize
from waveformer_tpu_torch.parallel.collectives import AxisShard

DHW = (1, 2, 3)


def neighbour_planes(x: torch.Tensor, shard: AxisShard, planes: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `planes` planes just before and just after this rank's slab x
    (B, Dl, ...): the previous rank's last and the next rank's first, zeros
    beyond the volume's edges."""
    p, dl = planes, x.shape[1]
    if dl < p:
        raise ValueError(f"a halo of {p} planes needs slabs of at least {p}, got {dl}")
    edges = shard.gather(torch.cat([x[:, :p], x[:, dl - p:]], dim=1))  # (S, B, 2p, ...)
    zeros = torch.zeros_like(x[:, :p])
    below = edges[shard.rank - 1][:, p:] if shard.rank > 0 else zeros
    above = edges[shard.rank + 1][:, :p] if shard.rank < shard.size - 1 else zeros
    return below, above


def halo(x: torch.Tensor, shard: AxisShard, planes: int = 1) -> torch.Tensor:
    """x's slab with `planes` planes of each neighbour around it: (B, Dl + 2p,
    ...)."""
    below, above = neighbour_planes(x, shard, planes)
    return torch.cat([below, x, above], dim=1)


def gather_depth(x: torch.Tensor, shard: AxisShard, axis: int = 1,
                 replicated: bool = False) -> torch.Tensor:
    """The whole volume from every rank's slab along `axis` (1 channels-last,
    2 for (B, C, D, H, W)); x itself without a spatial axis. `replicated`:
    every rank's work on the result is the same (`AxisShard.gather`)."""
    if shard is None:
        return x
    g = shard.gather(x, replicated)
    return torch.cat(list(g.unbind(0)), dim=axis)


def own_planes(x: torch.Tensor, shard: AxisShard) -> torch.Tensor:
    """This rank's planes of a whole (B, D, ...) tensor."""
    dl = x.shape[1] // shard.size
    return x[:, shard.rank * dl:(shard.rank + 1) * dl]


def _dhw_sum(x32: torch.Tensor, shard: AxisShard) -> torch.Tensor:
    return shard.sum(x32.sum(dim=DHW, keepdim=True))


def instance_norm(x: torch.Tensor, eps: float, shard: AxisShard) -> torch.Tensor:
    """`models.common.instance_norm` of the whole volume, on this rank's
    slab: fp32, no affine."""
    x32 = x.float()
    n = x.shape[1] * x.shape[2] * x.shape[3] * shard.size
    mean = _dhw_sum(x32, shard) / n
    xc = x32 - mean
    var = _dhw_sum(xc * xc, shard) / n
    return xc * torch.rsqrt(var + eps)


def mean_dhw(x: torch.Tensor, shard: AxisShard) -> torch.Tensor:
    """`x.mean(dim=(1, 2, 3))` of the whole volume (fp32 sums, x's dtype)."""
    n = x.shape[1] * x.shape[2] * x.shape[3] * shard.size
    return (_dhw_sum(x.float(), shard) / n).reshape(x.shape[0], -1).to(x.dtype)


def conv3_same(x: torch.Tensor, weight: torch.Tensor, bias, shard: AxisShard) -> torch.Tensor:
    """The dense 3³ SAME conv (stride 1) of the whole volume on this rank's
    channels-last slab. The slab is convolved with zero padding, then the
    neighbours' planes add their share through the kernel's first (below)
    and last (above) tap plane to the first and last output plane: one
    plane a side crosses the cut and the slab is not copied."""
    below, above = neighbour_planes(x, shard)
    cf = lambda t: t.permute(0, 4, 1, 2, 3)
    out = F.conv3d(cf(x), weight, bias, padding=1).permute(0, 2, 3, 4, 1)
    for plane, taps, at in ((below, weight[:, :, :1], 0), (above, weight[:, :, 2:], -1)):
        if (at == 0 and shard.rank == 0) or (at == -1 and shard.rank == shard.size - 1):
            continue  # the volume's edge: zeros, as the padding
        extra = F.conv3d(cf(plane), taps, None, padding=(0, 1, 1)).permute(0, 2, 3, 4, 1)
        edge = out[:, at:at + 1] if at == 0 else out[:, at:]
        edge.copy_(edge.float() + extra.float())
    return out


def source_planes(n_in: int, n_out: int, align_corners: bool, start: int, stop: int):
    """For output planes [start, stop) of a linear resize n_in → n_out: the
    two source planes and their weights, computed in fp32 as ATen's
    `area_pixel_compute_source_index` and `guard_index_and_lambda` do."""
    j = np.arange(start, stop).astype(np.float32)
    if align_corners:
        scale = np.float32(n_in - 1) / np.float32(n_out - 1) if n_out > 1 else np.float32(0)
        src = scale * j
    else:
        scale = np.float32(n_in) / np.float32(n_out)
        src = np.maximum(scale * (j + np.float32(0.5)) - np.float32(0.5), np.float32(0))
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    lam = np.clip(src - i0.astype(np.float32), np.float32(0), np.float32(1))
    return i0, np.minimum(i0 + 1, n_in - 1), np.float32(1) - lam, lam


def resize_trilinear(x: torch.Tensor, out_size: Sequence[int], align_corners: bool = False,
                     shard: AxisShard = None) -> torch.Tensor:
    """`ops.resize.resize_trilinear` of channels-last x to the global
    `out_size` (D, H, W); with a spatial shard, this rank's output planes
    of the whole volume's resize. Each plane of the slab and one of each
    neighbour is resized in H and W (`F.interpolate`, bilinear), then the
    output planes are the two source planes' weighted sum at their global
    positions, in fp32 with one rounding to x's dtype."""
    if shard is None:
        return resize.resize_trilinear(x, out_size, align_corners=align_corners)
    d_out, h_out, w_out = (int(s) for s in out_size)
    b, dl_in, h, w, c = x.shape
    d_in = dl_in * shard.size
    if (d_in, h, w) == (d_out, h_out, w_out):
        return x
    if d_out % shard.size:
        raise ValueError(f"output depth {d_out} does not split over {shard.size} ranks")
    dl_out = d_out // shard.size
    i0, i1, w0, w1 = source_planes(d_in, d_out, align_corners, shard.rank * dl_out,
                                   (shard.rank + 1) * dl_out)
    first = shard.rank * dl_in - 1  # the plane before the slab, halo's plane 0
    if i0.min() < first or i1.max() > first + dl_in + 1:
        raise ValueError("a resize plane lies beyond the one-plane halo")
    xh = halo(x, shard).float()
    n = xh.shape[1]
    planes = F.interpolate(xh.reshape(b * n, h, w, c).permute(0, 3, 1, 2),
                           size=(h_out, w_out), mode="bilinear", align_corners=align_corners)
    planes = planes.permute(0, 2, 3, 1).reshape(b, n, h_out, w_out, c)
    take = lambda i: planes[:, torch.from_numpy(i - first).to(x.device)]
    weight = lambda v: torch.from_numpy(v).to(x.device).view(1, -1, 1, 1, 1)
    return (take(i0) * weight(w0) + take(i1) * weight(w1)).to(x.dtype)
