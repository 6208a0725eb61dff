"""Diagonal Gaussian mixtures: EM fitting, posteriors and seeded labelling.

Port of `waveformer_tpu/ops/gmm.py` (the JAX package's answer to MONAI's
`_extensions/gmm`, used for interactive segmentation). The E and M steps
are matmuls and reductions on the features' device. `gmm_fit` keeps the
JAX op's `seed`: its k distinct initial rows are drawn by `_init_indices`
from a CPU `torch.Generator`, so a fit on the card starts where the same
fit on the CPU does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GMMParams(NamedTuple):
    weights: torch.Tensor  # (K,)
    means: torch.Tensor  # (K, C)
    variances: torch.Tensor  # (K, C), diagonal covariance


def _log_prob(params: GMMParams, x: torch.Tensor) -> torch.Tensor:
    """(N, C) → (N, K) component log-densities plus the log weight."""
    var = params.variances.clamp_min(1e-6)
    diff = x[:, None, :] - params.means[None]  # (N, K, C)
    ll = -0.5 * torch.sum(diff ** 2 / var[None] + torch.log(2 * math.pi * var)[None], dim=-1)
    return ll + torch.log(params.weights.clamp_min(1e-12))[None]


def _init_indices(n: int, k: int, seed: int) -> torch.Tensor:
    """k distinct row indices in [0, n), drawn from `seed` on the CPU."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g)[:k]


def gmm_fit(x: torch.Tensor, n_components: int, n_iters: int = 20, seed: int = 0) -> GMMParams:
    """Fit a diagonal-covariance GMM to (N, C) features with `n_iters` EM
    steps from k distinct seeded rows, equal weights and the population
    variance plus 1e-3."""
    n, _ = x.shape
    x = x.float()
    idx = _init_indices(n, n_components, seed).to(x.device)
    params = GMMParams(
        weights=torch.full((n_components,), 1.0 / n_components, device=x.device),
        means=x[idx],
        variances=torch.var(x, dim=0, unbiased=False)[None].repeat(n_components, 1) + 1e-3,
    )
    for _ in range(n_iters):
        resp = torch.softmax(_log_prob(params, x), dim=1)  # (N, K)
        nk = resp.sum(dim=0) + 1e-8  # (K,)
        means = (resp.T @ x) / nk[:, None]
        sq = (resp.T @ (x ** 2)) / nk[:, None]
        params = GMMParams(nk / n, means, (sq - means ** 2).clamp_min(1e-6))
    return params


def gmm_posterior(params: GMMParams, x: torch.Tensor) -> torch.Tensor:
    """(N, C) → (N, K) responsibilities."""
    return torch.softmax(_log_prob(params, x.float()), dim=1)


def gmm_segment(volume: torch.Tensor, seeds: torch.Tensor, n_components_per_class: int = 2,
                n_classes: int = 2, n_iters: int = 20) -> torch.Tensor:
    """Label every voxel by its most likely class, one mixture fitted per
    seeded class (MONAI's GMM use case).

    volume: (D, H, W, C) features; seeds: (D, H, W) int, −1 = unseeded.
    Class `cls` is fitted (with `seed=cls`) on the first 4096 rows of a
    stable argsort of "not seeded with cls": its seeds in voxel order, then,
    where it has fewer than 4096, unseeded voxels in voxel order."""
    feats = volume.reshape(-1, volume.shape[-1]).float()
    seeds_flat = seeds.reshape(-1)
    scores = []
    for cls in range(n_classes):
        unseeded = (seeds_flat != cls).to(torch.uint8)
        idx = torch.argsort(unseeded, stable=True)
        sel = feats[idx[:4096]]
        params = gmm_fit(sel, n_components_per_class, n_iters, seed=cls)
        scores.append(torch.logsumexp(_log_prob(params, feats), dim=1))
    return torch.argmax(torch.stack(scores, dim=1), dim=1).reshape(seeds.shape)
