"""The device mesh over `torch.distributed`: one process per rank.

Port of `waveformer_tpu/parallel/mesh.py`. The JAX package drives one
logical device mesh from one controller; the reference
(`light_training/trainer.py:355-358`, `launch.py:69-117`) and this port run
one process per rank, started by `torchrun`, in one process group. A
`Mesh` is this process's place in it: its coordinate on each of the three
axes, a group for its line of each axis that is longer than 1, and the
device that host values go to for a collective (the card under NCCL, the
CPU under gloo).

  * `init_distributed` joins the group from the variables `torchrun` sets
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL on the
    card, gloo when the caller asks for the CPU or for gloo.
  * `make_mesh` lays the ranks out as JAX's `make_mesh` lays out devices,
    rank = (d·S + s)·T + t (`mesh_coords`). A spec with only `data` above 1
    puts every rank of the group on `data`, with no new group. Otherwise
    every rank makes one group per line of each axis longer than 1
    (`axis_lines`), in the same order.
  * `data` keeps `Mesh.rank`, `Mesh.group` and `Mesh.size`: the trainers'
    data parallelism and `predict_cases_sharded` read only these.
    `spatial` (the depth D of a volume, `parallel/spatial.py`) and `tensor`
    (Megatron slices of the attention and FFN, `parallel/tensor_sharding.py`)
    are `AxisShard`s that `parallel/model_parallel.py::shard_model` hands
    to the model, for the serving forward and for training (the
    collectives' backwards, `collectives.AxisShard`).
  * `shard_batch` keeps this rank's rows of a global batch, and its D slab
    when `spatial` > 1 (JAX's `batch_spec`); `replicate` broadcasts tensors
    from the rank at (0, 0, 0) to every rank, in place.

Without an initialised group, `make_mesh()` is a mesh of one process with
no group, on which nothing communicates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from datetime import timedelta
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from waveformer_tpu_torch.parallel.collectives import AxisShard, Traffic


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
    """This process's place in a mesh of processes: `rank` and `group` are
    its coordinate and line on `data`, `spatial` and `tensor` its lines of
    the model-parallel axes (None where the axis has length 1)."""

    spec: MeshSpec
    rank: int = 0
    # None: one process on the data axis; nothing communicates on it
    group: Optional[dist.ProcessGroup] = None
    # where host values go for a collective: the card under NCCL
    device: torch.device = torch.device("cpu")
    spatial: Optional[AxisShard] = None
    tensor: Optional[AxisShard] = None
    # what the spatial and tensor collectives moved
    traffic: Traffic = dataclasses.field(default_factory=Traffic)
    # every rank of the mesh (the data line's group on a data mesh)
    world: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.spec.axis_names, self.spec.shape))

    @property
    def size(self) -> int:
        """Processes on the `data` axis."""
        return self.spec.data

    @property
    def coords(self) -> Tuple[int, int, int]:
        """(data, spatial, tensor) coordinates of this process."""
        return (self.rank, *(0 if a is None else a.rank for a in (self.spatial, self.tensor)))

    @property
    def spatial_group(self) -> Optional[dist.ProcessGroup]:
        return None if self.spatial is None else self.spatial.group

    @property
    def tensor_group(self) -> Optional[dist.ProcessGroup]:
        return None if self.tensor is None else self.tensor.group

    @property
    def is_main(self) -> bool:
        """The process at (0, 0, 0), the one that writes logs and checkpoints."""
        return self.coords == (0, 0, 0)

    def barrier(self) -> None:
        """Wait for every rank (an all-reduce of one element on the
        collective device, which both backends carry)."""
        if self.world is not None:
            dist.all_reduce(torch.zeros(1, device=self.device), group=self.world)


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


def mesh_coords(rank: int, spec: MeshSpec) -> Tuple[int, int, int]:
    """(data, spatial, tensor) coordinates of `rank`: where JAX's
    `np.asarray(devices).reshape(data, spatial, tensor)` puts device
    `rank`, so rank = (d·S + s)·T + t."""
    return tuple(int(i) for i in np.unravel_index(rank, spec.shape))


def axis_lines(spec: MeshSpec, axis: str) -> List[List[int]]:
    """The ranks of every line along `axis` (the others fixed), each in
    axis order; the lines in rank order of their first member."""
    grid = np.arange(spec.size()).reshape(spec.shape)
    a = spec.axis_names.index(axis)
    return np.moveaxis(grid, a, -1).reshape(-1, spec.shape[a]).tolist()


def make_mesh(spec: Optional[MeshSpec] = None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """A mesh of the ranks of `group` (the default group), every rank on
    `data` without a spec; a mesh of one process when no group is
    initialised. Every process of the job calls it with the same spec: a
    model-parallel spec makes its lines with `dist.new_group`, which every
    process enters."""
    if dist.is_initialized():
        group = group or dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    else:
        world, rank, group, device = 1, 0, None, torch.device("cpu")
    spec = spec or MeshSpec(data=world)
    if spec.size() != world:
        if group is None and (spec.spatial > 1 or spec.tensor > 1):
            # JAX's one controller places such a mesh on its devices; the
            # port needs one process per rank
            raise NotImplementedError(
                f"mesh spec {spec.shape}: a model-parallel mesh needs one process "
                "per rank (start them with torchrun); this process has no group")
        raise ValueError(f"mesh spec {spec.shape} needs {spec.size()} processes, "
                         f"got {world}")
    if spec.spatial == spec.tensor == 1:
        return Mesh(spec, rank, group, device, world=group)
    lines = {}
    for a, axis in enumerate(spec.axis_names):
        if spec.shape[a] == 1:
            continue
        for members in axis_lines(spec, axis):
            g = dist.new_group([dist.get_global_rank(group, m) for m in members])
            if rank in members:
                lines[axis] = g
    d, s, t = mesh_coords(rank, spec)
    traffic = Traffic()
    shard = lambda axis, coord, n: AxisShard(lines[axis], coord, n, traffic) if n > 1 else None
    return Mesh(spec, d, lines.get("data"), device, spatial=shard("spatial", s, spec.spatial),
                tensor=shard("tensor", t, spec.tensor), traffic=traffic, world=group)


def default_mesh_for_batch(batch_size: int) -> Mesh:
    """The data mesh over every process; raises unless the world size
    divides the global batch (the JAX function drops devices instead,
    which one process per card cannot do)."""
    mesh = make_mesh()
    if batch_size % mesh.size:
        raise ValueError(f"global batch {batch_size} does not split over "
                         f"{mesh.size} processes")
    return mesh


def depth_slab(mesh: Mesh, a, depth_axis: int = 1):
    """This rank's planes of `a` (an array or tensor, or a dict of them)
    along `depth_axis` when `spatial` > 1; `a` itself otherwise."""
    if isinstance(a, dict):
        return {k: depth_slab(mesh, v, depth_axis) for k, v in a.items()}
    s = mesh.spatial
    if s is None:
        return a
    d = a.shape[depth_axis]
    if d % s.size:
        raise ValueError(f"depth {d} does not split over {s.size} spatial ranks")
    index = [slice(None)] * a.ndim
    index[depth_axis] = slice(s.rank * d // s.size, (s.rank + 1) * d // s.size)
    return a[tuple(index)]


def shard_batch(mesh: Mesh, batch, depth_axis: Optional[int] = 1):
    """This rank's rows of a global batch (an array or tensor, or a dict of
    them) and, when `spatial` > 1, its planes along `depth_axis` (1 for
    channels-last (B, D, H, W, C), 2 for (B, C, D, H, W); None keeps every
    plane)."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, depth_axis) for k, v in batch.items()}
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"global batch {n} does not split over {mesh.size} processes")
    b = n // mesh.size
    rows = batch[mesh.rank * b:(mesh.rank + 1) * b]
    return rows if depth_axis is None else depth_slab(mesh, rows, depth_axis)


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Broadcast `tensors` from the rank at (0, 0, 0) to every rank of the
    mesh in place (params, optimizer state), one flat buffer per dtype and
    device; returns them."""
    if mesh.world is None:
        return tensors
    by_kind: Dict[Tuple[torch.dtype, torch.device], list] = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    src = dist.get_global_rank(mesh.world, 0)
    with torch.no_grad():
        for ts in by_kind.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src, group=mesh.world)
            for t, f in zip(ts, torch.split(flat, [t.numel() for t in ts])):
                t.copy_(f.view_as(t))
    return tensors


@contextlib.contextmanager
def main_rank_first(mesh: Optional[Mesh]) -> Iterator[None]:
    """Rank 0 runs the body first (it may write files the others then read:
    the persisted split, unpacked cases); the other ranks run it after."""
    if mesh is None or mesh.world is None:
        yield
        return
    if not mesh.is_main:
        mesh.barrier()
    yield
    if mesh.is_main:
        mesh.barrier()
