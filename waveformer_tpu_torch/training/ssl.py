"""Self-supervised pretraining: losses, augment ops, and the step-based trainer.

Port of `waveformer_tpu/training/ssl.py` (the reference SSL stack,
`self_supervised/`):
  * `nt_xent` — SimCLR contrastive loss (`loss.py:6-61`): each embedding
    divided by its norm plus 1e-8 (not `F.normalize`'s clamp), the
    similarities in fp32, the `1 - eye` mask;
  * `ssl_total_loss` — the reference's combination
    `contrast·recon + recon` (`loss.py:102`);
  * augment ops (`ops.py:17-122`): random block drop/replace, in-plane
    90° rotations with labels, context-restoration patch swaps — host
    numpy, with the JAX package's `RandomState` calls in its order, so a
    seed gives the same arrays;
  * `SSLTrainer` — step-based loop with warmup-cosine LR, periodic
    validation on held-out volumes (L1 recon), best-checkpoint tracking
    (`train.py:21-310` capability) on one device. The step
    (`make_ssl_step`) runs two forwards (the two views) against the batch,
    the backward, and AdamW without clipping on fp32 masters
    (`training/state.py`).

With a `mesh` (`parallel/mesh.py`, one process per card), where the JAX
trainer shards the batch over its mesh's data axis, each rank runs its own
rows of the global batch: NT-Xent takes its negatives from the global 2B
embeddings, gathered with `all_gather_with_grad`, the recon L1 is the
global mean, so `total` is the same scalar on every rank, and the
gradients are averaged over the ranks before AdamW (`GradientReducer`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from waveformer_tpu_torch.parallel.collectives import all_gather_with_grad, cross_replica_mean
from waveformer_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from waveformer_tpu_torch.training.checkpoint import CheckpointManager
from waveformer_tpu_torch.training.schedules import warmup_cosine_schedule
from waveformer_tpu_torch.training.state import (
    GradientReducer,
    TrainState,
    backward_and_update,
    make_optimizer,
    master_params,
)
from waveformer_tpu_torch.training.trainer import upload
from waveformer_tpu_torch.utils.jax_params import ssl_params_tree
from waveformer_tpu_torch.utils.logger import SummaryWriter, get_logger


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #


def nt_xent(z_i: torch.Tensor, z_j: torch.Tensor, temperature: float = 0.5,
            group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """SimCLR NT-Xent over 2B embeddings (`loss.py:6-61` semantics); with
    `group`, over the 2B embeddings of the global batch, every rank's rows
    gathered in rank order."""
    if group is not None:
        z_i, z_j = (all_gather_with_grad(z, group).flatten(0, 1) for z in (z_i, z_j))
    b = z_i.shape[0]
    z_i = z_i / (torch.linalg.vector_norm(z_i, dim=1, keepdim=True) + 1e-8)
    z_j = z_j / (torch.linalg.vector_norm(z_j, dim=1, keepdim=True) + 1e-8)
    z = torch.cat([z_i, z_j], dim=0).float()
    sim = z @ z.T  # cosine similarities (already normalized)
    pos = torch.cat([torch.diagonal(sim, b), torch.diagonal(sim, -b)])
    mask = 1.0 - torch.eye(2 * b, device=z.device)
    denom = torch.sum(mask * torch.exp(sim / temperature), dim=1)
    return torch.sum(-torch.log(torch.exp(pos / temperature) / denom)) / (2 * b)


def ssl_total_loss(
    c1, c2, rec1, rec2, gt1, gt2, temperature: float = 0.5,
    alpha_contrast: float = 1.0, alpha_recon: float = 1.0,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """total = α_c · contrast · recon + α_r · recon (`loss.py:102`); with
    `group`, of the global batch (each rank the same number of rows)."""
    contrast = nt_xent(c1, c2, temperature, group)
    rec = 0.5 * (torch.mean(torch.abs(rec1 - gt1)) + torch.mean(torch.abs(rec2 - gt2)))
    if group is not None:
        rec = cross_replica_mean(rec, group)
    total = alpha_contrast * contrast * rec + alpha_recon * rec
    return total, {"contrast": contrast, "recon": rec}


# --------------------------------------------------------------------------- #
# augment ops (host numpy; reference `ops.py`)
# --------------------------------------------------------------------------- #


def patch_rand_drop(
    x: np.ndarray,
    x_rep: Optional[np.ndarray] = None,
    max_drop: float = 0.3,
    max_block_sz: float = 0.25,
    tolr: float = 0.05,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Random block erase/replace (`ops.py:17-44`); x is (C, D, H, W)."""
    rng = rng or np.random.RandomState()
    c, h, w, z = x.shape
    n_drop = rng.uniform(0, max_drop) * h * w * z
    mx = (int(h * max_block_sz), int(w * max_block_sz), int(z * max_block_sz))
    tol = (int(tolr * h), int(tolr * w), int(tolr * z))
    x = x.copy()
    total = 0
    while total < n_drop:
        r = rng.randint(0, h - tol[0])
        cc = rng.randint(0, w - tol[1])
        s = rng.randint(0, z - tol[2])
        r2 = min(rng.randint(tol[0] + 1, max(mx[0], tol[0] + 2)) + r, h)
        c2 = min(rng.randint(tol[1] + 1, max(mx[1], tol[1] + 2)) + cc, w)
        s2 = min(rng.randint(tol[2] + 1, max(mx[2], tol[2] + 2)) + s, z)
        if min(r2 - r, c2 - cc, s2 - s) <= 0:
            continue
        if x_rep is None:
            noise = rng.standard_normal((c, r2 - r, c2 - cc, s2 - s)).astype(
                x.dtype
            )
            noise = (noise - noise.min()) / (noise.max() - noise.min() + 1e-8)
            x[:, r:r2, cc:c2, s:s2] = noise
        else:
            x[:, r:r2, cc:c2, s:s2] = x_rep[:, r:r2, cc:c2, s:s2]
        total += (r2 - r) * (c2 - cc) * (s2 - s)
    return x


def rot_rand(
    x: np.ndarray, rng: Optional[np.random.RandomState] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Random in-plane 90° rotations per sample with labels
    (`ops.py:46-64`); x is (B, C, D, H, W)."""
    rng = rng or np.random.RandomState()
    out = x.copy()
    labels = np.zeros(x.shape[0], np.int32)
    for i in range(x.shape[0]):
        k = rng.randint(0, 4)
        labels[i] = k
        if k:
            out[i] = np.rot90(x[i], k, axes=(2, 3))
    return out, labels


def aug_rand(
    x: np.ndarray, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """Per-sample block drop + cross-sample block replace (`ops.py:67-75`)."""
    rng = rng or np.random.RandomState()
    out = x.copy()
    n = x.shape[0]
    for i in range(n):
        out[i] = patch_rand_drop(out[i], rng=rng)
        j = rng.randint(0, n)
        if j != i:
            out[i] = patch_rand_drop(out[i], out[j], rng=rng)
    return out


def augment_context_restoration(
    x: np.ndarray,
    num_swaps: int = 3,
    max_patch_fraction: float = 0.2,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Swap random same-volume patches (`ops.py:78-122`); x is (C, D, H, W)."""
    rng = rng or np.random.RandomState()
    x = x.copy()
    c, h, w, z = x.shape
    for _ in range(num_swaps):
        ph = rng.randint(1, max(int(h * max_patch_fraction), 2))
        pw = rng.randint(1, max(int(w * max_patch_fraction), 2))
        pd = rng.randint(1, max(int(z * max_patch_fraction), 2))
        r1, c1, s1 = (rng.randint(0, h - ph), rng.randint(0, w - pw),
                      rng.randint(0, z - pd))
        r2, c2, s2 = (rng.randint(0, h - ph), rng.randint(0, w - pw),
                      rng.randint(0, z - pd))
        p1 = x[:, r1:r1 + ph, c1:c1 + pw, s1:s1 + pd].copy()
        p2 = x[:, r2:r2 + ph, c2:c2 + pw, s2:s2 + pd].copy()
        x[:, r1:r1 + ph, c1:c1 + pw, s1:s1 + pd] = p2
        x[:, r2:r2 + ph, c2:c2 + pw, s2:s2 + pd] = p1
    return x


def make_two_views(
    batch_cdhw: np.ndarray, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray]:
    """Two context-restoration views per volume (`train.py` usage)."""
    v1 = np.stack([
        augment_context_restoration(s, rng=rng) for s in batch_cdhw
    ])
    v2 = np.stack([
        augment_context_restoration(s, rng=rng) for s in batch_cdhw
    ])
    return v1, v2


# --------------------------------------------------------------------------- #
# step and trainer
# --------------------------------------------------------------------------- #


def make_ssl_step(model: torch.nn.Module, temperature: float = 0.5,
                  mesh: Optional[Mesh] = None):
    """`step(state, v1, v2, gt) -> (state, metrics)`: the module on both
    views, `ssl_total_loss` against `gt` for both, the backward, fp32 gradients,
    the optimizer step on the masters and the masters back into the
    module. `metrics` holds device scalars: the loss, its contrast and
    recon parts, and the unclipped gradient norm. With a mesh that has a
    group, v1, v2 and gt are this rank's rows of the global batch and the
    loss is the global batch's (see the module's docstring)."""
    named = dict(model.named_parameters())
    group = mesh.group if mesh is not None else None
    reducer = GradientReducer(mesh) if group is not None else None

    def step(state: TrainState, v1: torch.Tensor, v2: torch.Tensor, gt: torch.Tensor):
        c1, r1 = model(v1)
        c2, r2 = model(v2)
        total, parts = ssl_total_loss(c1, c2, r1, r2, gt, gt, temperature, group=group)
        norm, loss = backward_and_update(state, total, named, model, reducer)
        return state, {"loss": loss, "contrast": parts["contrast"].detach(),
                       "recon": parts["recon"].detach(), "grad_norm": norm}

    step.reducer = reducer
    return step


class SSLTrainer:
    """Step-based SSL pretraining loop (`self_supervised/train.py:21-310`).

    The model (an `SSLViT`) is built by the caller in fp32 on the device it
    trains on; the trainer casts it to `compute_dtype` once its fp32
    weights have become the masters (`master_params`). The JAX trainer's
    dropout key is left out with the model's dropout (rate 0 in the
    script).

    With a `mesh`, the batch iterator yields the global batch on every
    rank; every rank makes the same two views of it (one host generator
    seeded alike) and trains on its own rows. The masters are broadcast
    from rank 0 at the start; validation runs on every rank alike; rank 0
    alone writes TensorBoard scalars and checkpoints. The ranks must divide
    the global batch (`shard_batch` raises otherwise)."""

    def __init__(
        self,
        model: torch.nn.Module,
        num_steps: int = 10000,
        lr: float = 4e-4,
        weight_decay: float = 1e-5,
        warmup_steps: int = 500,
        eval_every: int = 100,
        temperature: float = 0.5,
        logdir: str = "./logs_ssl",
        mesh: Optional[Mesh] = None,
        seed: int = 42,
        # the dtype the module computes in, from train() on
        compute_dtype: torch.dtype = torch.float32,
    ):
        self.model = model
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = next(model.parameters()).device
        self.num_steps = num_steps
        self.eval_every = eval_every
        self.temperature = temperature
        self.logdir = logdir
        self.seed = seed
        self.compute_dtype = compute_dtype
        self.log = get_logger()
        self.schedule = warmup_cosine_schedule(lr, warmup_steps, num_steps)
        self.tx = make_optimizer(lr=self.schedule, weight_decay=weight_decay,
                                 grad_clip_norm=None)
        self.ckpt = CheckpointManager(os.path.join(logdir, "model")) if self.is_main else None
        self.best_val = np.inf
        # per step: (host seconds from its start to the next batch in hand,
        # of which waiting on the batch iterator)
        self.step_times: List[Tuple[float, float]] = []
        # per step: the (global) loss as a device scalar, read without a sync
        self.losses: List[torch.Tensor] = []

    def _init_state(self) -> TrainState:
        state = TrainState.create(master_params(self.model, self.compute_dtype), self.tx)
        if self.mesh is not None:
            replicate(self.mesh, list(state.params.values()))
            state.copy_to(self.model)
        return state

    def params_tree(self) -> Dict:
        """The masters as the JAX package's `SSLViT` params tree."""
        return ssl_params_tree(self.state.params, self.model.num_heads)

    def train(
        self,
        batch_iterator: Iterable[np.ndarray],
        val_batches: Optional[Sequence[np.ndarray]] = None,
    ) -> float:
        """`batch_iterator` yields (B, D, H, W, C) volumes (channels-last);
        returns the best validation L1 reconstruction."""
        writer = SummaryWriter(self.logdir) if self.is_main else None
        rng_np = np.random.RandomState(self.seed)
        it = iter(batch_iterator)
        first = next(it)
        self.state = self._init_state()
        step_fn = self.step_fn = make_ssl_step(self.model, self.temperature, self.mesh)
        n_params = sum(int(p.numel()) for p in self.state.params.values())
        self.log.info(f"SSL model: {n_params:,} params")

        def rows(a):
            return a if self.mesh is None else shard_batch(self.mesh, a)

        def views(gt):
            cdhw = gt.transpose(0, 4, 1, 2, 3)
            v1, v2 = make_two_views(cdhw, rng_np)
            return (upload(rows(v.transpose(0, 2, 3, 4, 1)), self.device) for v in (v1, v2))

        gt = first
        self.model.train()
        try:
            for step_i in range(self.num_steps):
                t0 = time.perf_counter()
                v1, v2 = views(gt)
                _, metrics = step_fn(self.state, v1, v2, upload(rows(gt), self.device))
                self.losses.append(metrics["loss"])
                if step_i % 10 == 0 and writer is not None:
                    scalars = {k: float(metrics[k]) for k in ("loss", "contrast", "recon")}
                    writer.add_scalars(scalars, step_i)
                    self.log.info(
                        f"ssl step {step_i}: loss {scalars['loss']:.4f} "
                        f"(contrast {scalars['contrast']:.4f}, "
                        f"recon {scalars['recon']:.4f})"
                    )
                if val_batches and (step_i + 1) % self.eval_every == 0:
                    val = self._validate(val_batches)
                    if writer is not None:
                        writer.add_scalar("val_recon_l1", val, step_i)
                    if val < self.best_val:
                        self.best_val = val
                        if self.ckpt is not None:
                            self.ckpt.save_best(self.params_tree(), -val, step_i, "ssl_vit")
                t1 = time.perf_counter()
                gt = next(it, None)
                t2 = time.perf_counter()
                self.step_times.append((t2 - t0, t2 - t1))
                if gt is None:
                    break
        finally:
            self.model.eval()
        if self.ckpt is not None:
            self.ckpt.save_final(self.params_tree(), 0.0, self.num_steps, "ssl_vit")
            writer.close()
        if self.mesh is not None:
            self.mesh.barrier()
        return self.best_val

    def _validate(self, val_batches) -> float:
        losses = []
        self.model.eval()
        with torch.no_grad():
            for gt in val_batches:
                g = upload(gt, self.device)
                _, rec = self.model(g)
                losses.append(float(torch.mean(torch.abs(rec - g))))
        self.model.train()
        return float(np.mean(losses))
