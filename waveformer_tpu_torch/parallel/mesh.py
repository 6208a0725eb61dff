"""Data parallelism over `torch.distributed`: one process per card.

Port of the `data` axis of `waveformer_tpu/parallel/mesh.py`. The JAX
package drives one logical device mesh from one controller; the reference
(`light_training/trainer.py:355-358`, `launch.py:69-117`) and this port run
one process per card, started by `torchrun`, in one process group. A
`Mesh` is this process's place on the `data` axis: its rank, the group
and the device that host values go to for a collective (the card under
NCCL, the CPU under gloo).

  * `init_distributed` joins the group from the variables `torchrun` sets
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the
    card, gloo when the caller asks for the CPU or for gloo.
  * `make_mesh` puts every rank of the group on `data`. The `spatial` and
    `tensor` axes (the JAX package's depth sharding and
    `parallel/tensor_sharding.py`) are not ported: a spec with either
    above 1 raises.
  * `shard_batch` keeps this rank's rows of a global batch; `replicate`
    broadcasts tensors from rank 0, in place.

Without an initialised group, `make_mesh()` is a mesh of one process with
no group, on which nothing communicates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from datetime import timedelta
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; axes with size 1 are kept (cheap, explicit)."""

    data: int = 1
    spatial: int = 1
    tensor: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "spatial", "tensor")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.spatial, self.tensor)

    def size(self) -> int:
        return int(np.prod(self.shape))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the `data` axis of a process group."""

    spec: MeshSpec
    rank: int = 0
    # None: one process and no group; nothing communicates
    group: Optional[dist.ProcessGroup] = None
    # where host values go for a collective: the card under NCCL
    device: torch.device = torch.device("cpu")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.spec.axis_names, self.spec.shape))

    @property
    def size(self) -> int:
        """Processes on the `data` axis."""
        return self.spec.data

    @property
    def is_main(self) -> bool:
        """Rank 0, the one process that writes logs and checkpoints."""
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce of one element on the
        collective device, which both backends carry)."""
        if self.group is not None:
            dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)


def init_distributed(
    device: Optional[Union[str, torch.device]] = None,
    backend: Optional[str] = None,
    init_method: str = "env://",
    timeout: Optional[timedelta] = None,
) -> torch.device:
    """Join the process group as `torchrun` describes it in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK; MASTER_ADDR and MASTER_PORT
    for `env://`) and return this process's device.

    On the card (`device` None or CUDA) the process takes card LOCAL_RANK
    (`torch.cuda.set_device` before the group is made) and the backend is
    NCCL; with `device="cpu"` it is gloo. `backend="gloo"` on the card runs
    gloo with CUDA tensors (two ranks on one card, which NCCL refuses)."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device='cpu' for gloo")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    return dev


def world_size() -> int:
    """Processes in the default group, or WORLD_SIZE of a launch that has
    not joined it yet, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(spec: Optional[MeshSpec] = None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """A mesh of every rank of `group` (the default group) on `data`; a
    mesh of one process when no group is initialised."""
    if dist.is_initialized():
        group = group or dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    else:
        world, rank, group, device = 1, 0, None, torch.device("cpu")
    spec = spec or MeshSpec(data=world)
    if spec.spatial > 1 or spec.tensor > 1:
        raise NotImplementedError(
            f"mesh spec {spec.shape}: only the data axis is ported "
            "(spatial and tensor sharding are not)")
    if spec.size() != world:
        raise ValueError(f"mesh spec {spec.shape} needs {spec.size()} processes, "
                         f"got {world}")
    return Mesh(spec, rank, group, device)


def default_mesh_for_batch(batch_size: int) -> Mesh:
    """The data mesh over every process; raises unless the world size
    divides the global batch (the JAX function drops devices instead,
    which one process per card cannot do)."""
    mesh = make_mesh()
    if batch_size % mesh.size:
        raise ValueError(f"global batch {batch_size} does not split over "
                         f"{mesh.size} processes")
    return mesh


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch: an array or tensor, or a dict of
    them."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"global batch {n} does not split over {mesh.size} processes")
    b = n // mesh.size
    return batch[mesh.rank * b:(mesh.rank + 1) * b]


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Broadcast `tensors` from rank 0 in place (params, optimizer state),
    one flat buffer per dtype and device; returns them."""
    if mesh.group is None:
        return tensors
    by_kind: Dict[Tuple[torch.dtype, torch.device], list] = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for ts in by_kind.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src, group=mesh.group)
            for t, f in zip(ts, torch.split(flat, [t.numel() for t in ts])):
                t.copy_(f.view_as(t))
    return tensors


@contextlib.contextmanager
def main_rank_first(mesh: Optional[Mesh]) -> Iterator[None]:
    """Rank 0 runs the body first (it may write files the others then read:
    the persisted split, unpacked cases); the other ranks run it after."""
    if mesh is None or mesh.group is None:
        yield
        return
    if not mesh.is_main:
        mesh.barrier()
    yield
    if mesh.is_main:
        mesh.barrier()
