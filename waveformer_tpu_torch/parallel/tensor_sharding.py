"""Tensor parallelism over the mesh's `tensor` axis.

Port of `waveformer_tpu/parallel/tensor_sharding.py`. The JAX package
places its parameters with Megatron column/row `PartitionSpec`s and GSPMD
inserts the collectives. Here each rank of a `tensor` line holds its
slices (`shard_params_tensor`), and the two modules that own them run the
collectives themselves once `model_parallel.shard_model` gives them the
line (`WindowAttention`, `CCF_FFN`). JAX's rules, carried through the key
map of `utils/jax_params.py` (a Dense kernel (in, out) is an `nn.Linear`
weight (out, in), a conv kernel (..., in, out) a Conv3d weight (out, in,
...)):

  * attention `qkv`: column-parallel, weight and bias split on dim 0. JAX
    splits the 3C output columns in contiguous chunks and GSPMD reshards
    q, k and v; the port splits by head: rank r of T takes rows
    j·C + [r·C/T, (r+1)·C/T) for j = 0, 1, 2, the q, k and v of heads
    [r·H/T, (r+1)·H/T), and its columns of the (replicated) bias table;
  * attention `proj`: row-parallel, weight split on dim 1, bias
    replicated; the partial products are summed in fp32 over the line and
    the bias added once (`row_parallel_linear`);
  * CCF_FFN `pwconv`: column-parallel, with the hidden `dwconv` and the
    hidden LayerNorms `norm1`/`norm2` split alike; the norms' statistics
    over the split hidden dim are fp32 sums over the line (`layer_norm`);
  * CCF_FFN `fc`: row-parallel, as `proj`;
  * everything else: replicated.

In training, the input of `qkv` and `pwconv` and the bias table go
through `AxisShard.copy` (identity forward, the cotangents summed
backward), the row-parallel sums through `AxisShard.reduce` (the
cotangent passed on) and the LayerNorm statistics through `AxisShard.sum`
(see `collectives.AxisShard`). A sliced parameter's gradient is then its
slice's, and `rows` says where the slice sits in the full tensor
(`training/state.py` gathers them).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from waveformer_tpu_torch.parallel.collectives import AxisShard
from waveformer_tpu_torch.parallel.mesh import Mesh

# (key suffix, the dim it splits); a key matching none is replicated
RULES = (
    (".attn.qkv.weight", 0), (".attn.qkv.bias", 0),
    (".attn.proj.weight", 1),
    (".mlp.pwconv.weight", 0), (".mlp.pwconv.bias", 0),
    (".mlp.dwconv.weight", 0), (".mlp.dwconv.bias", 0),
    (".mlp.norm1.weight", 0), (".mlp.norm1.bias", 0),
    (".mlp.norm2.weight", 0), (".mlp.norm2.bias", 0),
    (".mlp.fc.weight", 1),
)


def split_dim(key: str) -> Optional[int]:
    return next((dim for suffix, dim in RULES if key.endswith(suffix)), None)


def tensor_param_specs(model: nn.Module) -> Dict[str, Optional[int]]:
    """Every `state_dict` key of `model` → the dim its tensor splits over
    the `tensor` axis, or None (replicated)."""
    return {k: split_dim(k) for k in model.state_dict()}


def rows(key: str, n: int, rank: int, size: int) -> torch.Tensor:
    """The indices along its split dim (of extent n) of tensor rank `rank`'s
    slice of the parameter `key`."""
    chunks = 3 if ".attn.qkv." in key else 1  # q, k and v, each split by head
    if n % (chunks * size):
        raise ValueError(f"{key}: {n} does not split over {size} tensor ranks")
    c, w = n // chunks, n // chunks // size
    return torch.cat([torch.arange(j * c + rank * w, j * c + (rank + 1) * w)
                      for j in range(chunks)])


def shard_tensor(key: str, v: torch.Tensor, t: Optional[AxisShard]) -> torch.Tensor:
    """This rank's slice of the full parameter `key` (v itself where it is
    replicated or there is no tensor line)."""
    dim = split_dim(key)
    if t is None or dim is None:
        return v
    return v.index_select(dim, rows(key, v.shape[dim], t.rank, t.size).to(v.device))


def shard_params_tensor(mesh: Mesh, state_dict: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full `state_dict` on `mesh`'s tensor line
    (the state dict itself without one)."""
    return {k: shard_tensor(k, v, mesh.tensor) for k, v in state_dict.items()}


def row_parallel_linear(x: torch.Tensor, linear: nn.Linear, shard: AxisShard) -> torch.Tensor:
    """`linear` of the whole input from this rank's slice of its features:
    the partial product in fp32, summed over the line, then the bias once;
    x's dtype."""
    y = shard.reduce(F.linear(x.float(), linear.weight.float()))
    if linear.bias is not None:
        y = y + linear.bias.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, shard: AxisShard) -> torch.Tensor:
    """`norm` over the whole last dim from this rank's slice of it (and of
    the affine): fp32 mean, then variance, each summed over the line; x's
    dtype."""
    x32 = x.float()
    n = x.shape[-1] * shard.size
    mean = shard.sum(x32.sum(-1, keepdim=True)) / n
    xc = x32 - mean
    var = shard.sum((xc * xc).sum(-1, keepdim=True)) / n
    y = xc * torch.rsqrt(var + norm.eps) * norm.weight.float() + norm.bias.float()
    return y.to(x.dtype)
