"""Plain training step: MONAI's DiceCE (softmax, one-hot labels, Dice per
sample and class) and optax's `chain(clip_by_global_norm, adamw)` on
float32 parameters, written for the benchmark.

The loss of a batch is the mean of its samples' losses (Dice per sample
and class, then the mean; cross-entropy the mean over every voxel), so the
step runs one sample at a time and sums each sample's gradient divided by
the batch: the same gradient, in a fraction of the memory. Under data
parallelism a step is DDP's: each rank computes its shard of the global
batch on its own card, the shards' gradients and losses are summed in rank
order, then every rank takes the same clip and AdamW.
The model's stochastic depth comes from its architecture's module
(`port_bench/archs/`).
"""

from __future__ import annotations

import functools
from types import ModuleType
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def step_seed(seed: int, step: int) -> int:
    """The generator seed of a step's drop-path masks: a 63-bit hash of
    (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def dice_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, D, H, W, K), labels (B, D, H, W, 1) integers."""
    k = logits.shape[-1]
    onehot = F.one_hot(labels[..., 0].long(), k).float()
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    dims = tuple(range(1, logits.ndim - 1))
    inter = (probs * onehot).sum(dims)
    dice = (2.0 * inter + 1e-5) / (probs.sum(dims) + onehot.sum(dims) + 1e-5)
    ce = -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    return (1.0 - dice).mean() + ce


class AdamW:
    """optax `chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps, wd))`,
    every parameter decayed, the bias corrections rounded to float32 as
    optax rounds them."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float, weight_decay: float,
                 clip: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.clip, self.b1, self.b2, self.eps = lr, weight_decay, clip, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params: Sequence[torch.Tensor], grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Update `params` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if self.clip is not None and norm >= self.clip:
            grads = [g / norm * self.clip for g in grads]
        self.count += 1
        bc1 = float(1 - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(self.count))
        with torch.no_grad():
            for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
                mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
                nu.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.wd * p
                p.sub_(self.lr * upd)
        return grads


# (rank, world, gather): gather(flat) is every rank's `flat`, in rank order
Shard = Tuple[int, int, Callable[[torch.Tensor], List[torch.Tensor]]]


def run_steps(model: torch.nn.Module, batches: Sequence[Dict[str, torch.Tensor]], seed: int,
              optimizer: AdamW, arch: ModuleType, first_step: int = 0,
              shard: Optional[Shard] = None) -> Dict[str, object]:
    """Train `model` (float32, its parameters the masters) one step per
    batch, counting steps from `first_step`. Step t draws its drop-path
    masks (`arch.draw_drop_masks`) from a generator on the batch's device
    seeded with `step_seed(seed, t)`. With `shard`, each batch is this
    rank's rows of a global batch of `world` times as many: the masks are
    the global batch's, each sample's gradient is divided by the global
    batch, and the ranks' gradients and losses are summed in rank order.
    Returns each step's loss and the first step's clipped gradients by
    parameter name."""
    rank, world, gather = shard or (0, 1, None)
    named = dict(model.named_parameters())
    params = list(named.values())
    losses, first = [], None
    model.train()
    for t, batch in enumerate(batches, start=first_step):
        data, seg = batch["data"], batch["seg"]
        b = data.shape[0]
        gen = torch.Generator(device=data.device)
        gen.manual_seed(step_seed(seed, t))
        masks = arch.draw_drop_masks(model, b * world, gen, data.device)
        for p in params:
            p.grad = None
        loss = 0.0
        for i in range(b):
            j = rank * b + i
            arch.set_drop_masks(model, [tuple(None if m is None else m[j:j + 1] for m in pair)
                                        for pair in masks])
            li = dice_ce(model(data[i:i + 1]), seg[i:i + 1]) / (b * world)
            li.backward()
            loss += float(li.detach())
        arch.set_drop_masks(model, None)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if gather is not None:
            grads, loss = _summed(grads, loss, gather)
        clipped = optimizer.step(params, grads)
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(named, clipped)}
        losses.append(loss)
    for p in params:
        p.grad = None
    return {"losses": losses, "first_grads": first}


def _summed(grads: List[torch.Tensor], loss: float, gather) -> Tuple[List[torch.Tensor], float]:
    """Every rank's gradients and loss, summed in rank order."""
    flat = functools.reduce(torch.add, gather(torch.cat([g.reshape(-1) for g in grads])))
    parts = torch.split(flat, [g.numel() for g in grads])
    losses = gather(torch.tensor([loss], dtype=torch.float64, device=flat.device))
    return [p.view_as(g) for p, g in zip(parts, grads)], sum(float(x) for x in losses)
