"""`shard_model`: a `Waveformer` arranged for a forward, and its backward,
on a mesh's `spatial` and `tensor` axes.

The JAX package shards one forward by placing parameters and inputs
(`shard_params_tensor`, `batch_spec`) and letting GSPMD partition the
program. The port's modules run the collectives themselves: each module
that mixes values across the depth cut declares `depth_shard = None`, each
that owns tensor-parallel slices `tensor_shard = None`, and `shard_model`
gives them this rank's lines. A sharded forward then takes this rank's
rows and D slab (`mesh.shard_batch`) and returns this rank's slab of the
logits (`spatial.gather_depth` joins them):

    device = init_distributed()                      # under torchrun
    mesh = make_mesh(MeshSpec(data=1, spatial=2, tensor=3))
    model = shard_model(create_waveformer(cfg, device=device, seed=0), mesh)
    with torch.no_grad():
        y = model(torch.as_tensor(shard_batch(mesh, x)).to(device))
    logits = gather_depth(y, mesh.spatial)

Without a spatial or tensor axis the model is left as it was. To train,
take the fp32 masters first (`training.state.master_params`: full
tensors on every rank, as JAX's replicated state), then shard the module
(`Trainer(mesh=...)` does this in that order).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from waveformer_tpu_torch.parallel.mesh import Mesh
from waveformer_tpu_torch.parallel.tensor_sharding import shard_params_tensor


def check_model_parallel(model: nn.Module, mesh: Mesh) -> None:
    """Raise `ValueError` where `mesh` cannot split `model`: `tensor` must
    divide every attention's heads (the split is by head), and `spatial`
    the model's coarsest grid, so that every grid of the forward, from the
    input D down, splits into slabs of an even extent at even offsets (JAX
    takes any D; the port's DWT, patch merging and strided convs stay on
    one rank only so)."""
    t, s = mesh.spec.tensor, mesh.spec.spatial
    if (t > 1 or s > 1) and not getattr(model, "model_parallel", True):
        raise ValueError(f"{type(model).__name__} does not shard over a mesh's spatial or "
                         f"tensor line (spatial={s}, tensor={t})")
    for name, m in model.named_modules():
        if hasattr(m, "tensor_shard") and hasattr(m, "num_heads") and m.num_heads % t:
            raise ValueError(f"tensor={t} does not divide the {m.num_heads} heads of {name}")
    grids = [m.img_size[0] // 2 ** m.level for m in model.modules()
             if hasattr(m, "depth_shard") and hasattr(m, "level")]
    if s > 1 and grids and min(grids) % s:
        raise ValueError(
            f"spatial={s}: the input D must be divisible by {s}·2^k down to the model's "
            f"coarsest grid, whose {min(grids)} planes do not split over {s} ranks")


def _fit(m: nn.Module) -> None:
    """A module's size attributes after its parameters were sliced."""
    if isinstance(m, nn.Linear):
        m.out_features, m.in_features = m.weight.shape
    elif isinstance(m, nn.Conv3d) and m.weight.shape[0] != m.out_channels:
        m.out_channels = m.weight.shape[0]
        if m.groups > 1:  # depthwise: one input channel a group
            m.groups = m.in_channels = m.out_channels
    elif isinstance(m, nn.LayerNorm):
        m.normalized_shape = tuple(m.weight.shape)


def is_sharded(model: nn.Module, mesh: Mesh) -> bool:
    """Whether `shard_model(model, mesh)` armed `model` (always, on a mesh
    without spatial and tensor lines)."""
    lines = [(a, line) for a, line in (("depth_shard", mesh.spatial),
                                       ("tensor_shard", mesh.tensor)) if line is not None]
    return all(any(getattr(m, a, None) is line for m in model.modules()) for a, line in lines)


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Arm `model` (full weights, on this rank's device) for a forward on
    `mesh`: its tensor-parallel parameters become this rank's slices
    (`shard_params_tensor`; a full state dict sharded so loads into it
    afterwards) and its modules get the mesh's `tensor` and `spatial`
    lines. Returns `model`."""
    check_model_parallel(model, mesh)
    if mesh.tensor is not None:
        sliced = shard_params_tensor(mesh, model.state_dict())
        for name, p in list(model.named_parameters()):
            if sliced[name].shape != p.shape:
                # a new parameter: whoever holds the old one (the training
                # masters) keeps the full tensor
                owner, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(owner), leaf, nn.Parameter(
                    sliced[name].to(p.device, p.dtype), requires_grad=p.requires_grad))
        for m in model.modules():
            _fit(m)
            if hasattr(m, "tensor_shard"):
                m.tensor_shard = mesh.tensor
    if mesh.spatial is not None:
        for m in model.modules():
            if hasattr(m, "depth_shard"):
                m.depth_shard = mesh.spatial
    return model
