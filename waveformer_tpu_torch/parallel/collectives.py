"""Cross-process collectives over `torch.distributed`.

Port of `waveformer_tpu/parallel/collectives.py`, the reference's
distributed mechanisms:

  * `cross_replica_mean` — the all-reduce mean (JAX `pmean`);
  * `all_gather_with_grad` — a differentiable all-gather whose backward
    sums the cotangents of every rank and keeps this rank's slice (JAX's
    VJP of `all_gather`; nnUNet's `AllGatherGrad`,
    `light_training/loss/ddp_allgather.py:25-48`);
  * `gather_metrics` — eval rows of every rank in rank order
    (`SequentialDistributedSampler` + `distributed_concat`,
    `light_training/sampler.py:5-48`);
  * `SyncBatchNorm` — BatchNorm with global-batch moments
    (`SyncBatchNorm.convert_sync_batchnorm`,
    `light_training/trainer.py:354`), JAX's formula;
  * `shard_cases_for_eval` — the sampler's pad-and-slice, exactly as JAX.

Gradients. Every rank runs its own autograd, and a collective's backward
sums the cotangents that every rank's copy of the loss sends back
(`all_reduce` of the cotangents): the gradient of Σ_r L_r, where L_r is
rank r's loss. The data-parallel step (`training/state.py`) averages the
ranks' gradients, so it takes the gradient of the mean over ranks of L_r:
the global batch's loss, whether L_r is a local mean (each rank's own rows)
or a value every rank computes alike through these collectives (global
batch dice, NT-Xent over the gathered embeddings).

Only `all_reduce` and `broadcast` are used: they take the same form under
NCCL and gloo, on CPU and CUDA tensors (two ranks on one card run gloo,
which NCCL refuses), while the tensor all-gather has not (torch 2.13
deprecates `all_gather_into_tensor`, and gloo wants its output flat). The
all-gather is therefore an all-reduce of a zero-filled buffer in which
each rank writes its own slot (adding zeros is exact), and its backward an
all-reduce of the cotangents of which each rank keeps its slot: W times
the bytes of the direct collectives, for the embeddings and metric rows
they carry here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

ProcessGroup = Optional[dist.ProcessGroup]


def _all_reduce(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Σ over ranks; the backward is the same sum of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _gather(x: torch.Tensor, group: ProcessGroup) -> torch.Tensor:
    """(W, *x.shape): every rank's x in rank order."""
    buf = x.new_zeros((dist.get_world_size(group), *x.shape))
    buf[dist.get_rank(group)] = x
    return _all_reduce(buf, group)


class _AllGather(torch.autograd.Function):
    """Stack every rank's x; the backward sums the cotangents over ranks
    and keeps this rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group)[dist.get_rank(ctx.group)], None


def cross_replica_sum(x: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    """Σ of x over the ranks of `group`, differentiable (JAX `psum`)."""
    return _AllReduceSum.apply(x, group)


def cross_replica_mean(x: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    """Mean of x over the ranks of `group`, differentiable (JAX `pmean`)."""
    return cross_replica_sum(x, group) / dist.get_world_size(group)


def all_gather_with_grad(x: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    """Differentiable all-gather: (W, *x.shape), rank r's x at index r."""
    return _AllGather.apply(x, group)


def gather_metrics(values: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    """Every rank's eval rows (each rank the same count) concatenated in
    rank order; the equivalent of `distributed_concat`."""
    with torch.no_grad():
        g = _gather(values, group)
    return g.reshape((-1,) + tuple(values.shape[1:]))


class SyncBatchNorm(nn.Module):
    """BatchNorm over the channel (last) axis with global-batch moments.

    JAX's `SyncBatchNorm` formula: fp32 moments E[x] and E[x²] of this
    rank's rows, averaged over the ranks of `group` (so each rank must hold
    the same number of rows), var = max(E[x²] − E[x]², 0), biased in the
    running statistics too, which move as m·running + (1 − m)·batch with
    flax's momentum m = 0.9 (torch's 0.1). The output is fp32. With no
    group it is plain BatchNorm; in eval mode it uses the running
    statistics. Parameters and buffers carry torch's BatchNorm names
    (`weight`, `bias`, `running_mean`, `running_var`,
    `num_batches_tracked`), so reference state dicts load."""

    def __init__(self, features: int, group: ProcessGroup = None, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.features = features
        self.group = group
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            axes = tuple(range(x.ndim - 1))
            moments = torch.stack([x32.mean(axes), (x32 * x32).mean(axes)])
            if self.group is not None:
                moments = cross_replica_mean(moments, self.group)
            mean, mean2 = moments[0], moments[1]
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


def shard_cases_for_eval(n_cases: int, n_shards: int) -> Tuple[np.ndarray, int]:
    """`SequentialDistributedSampler` logic (`sampler.py:5-41`): pad the case
    list to a multiple of the shard count and slice sequentially. Returns the
    (n_shards, per_shard) index matrix and the true (unpadded) length."""
    per_shard = -(-n_cases // n_shards)
    idx = np.arange(per_shard * n_shards) % max(n_cases, 1)
    return idx.reshape(n_shards, per_shard), n_cases
