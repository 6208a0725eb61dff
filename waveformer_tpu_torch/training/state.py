"""Train state and step factories: fp32 masters, global-norm clip, AdamW.

Port of `waveformer_tpu/training/state.py` (the reference's fp32 step with
gradient clipping, `light_training/trainer.py:451-471`: AdamW lr 1e-4 at
`3_train.py:70`, `clip_grad_norm_(12)` at `trainer.py:466`).

The JAX model keeps fp32 parameters and computes in its compute dtype; its
optimizer state and updates are fp32. The port's module holds its
parameters in the compute dtype (`Waveformer.set_compute_dtype` casts them;
the relative-position tables stay fp32), so the train state keeps fp32
**master** parameters and fp32 AdamW moments beside it. A module to train
is built in fp32 and cast by `master_params(model, compute_dtype)` after
its fp32 weights have become the masters. A step
runs the module, upcasts its gradients (the VJP of JAX's parameter cast),
clips them, updates the masters and copies them back into the module. An
fp32 parameter is its own master and is updated in place.

The optimizer is `optax.chain(clip_by_global_norm(c), adamw(lr, b1, b2,
eps, weight_decay))` written out in optax's own form on the masters: the
clip scales by `c / norm` only when `norm >= c` (torch's `clip_grad_norm_`
divides by `norm + 1e-6`); the moments are `(1 - b)·g + b·m`, the bias
corrections `1 - b**t` are rounded to fp32 as optax rounds them (for b2 =
0.999 that alone moves an update by 6e-6 relative against float64, so
`torch.optim.AdamW` differs from optax by more than fp32 rounding), and
every parameter decays (optax's `adamw` with no mask). The updates are
`torch._foreach_*` calls over all masters, no host synchronisation; the
learning rate of step `t` is `schedule(t)`, the count before the step, as
optax reads it.

With a `mesh` (`parallel/mesh.py`, one process per card) the step is
JAX's global-batch step under `make_train_step(mesh=...)`: each rank runs
the forward on its own rows, and its fp32 gradients (not the compute-dtype
module's) go into one flat buffer with its loss, which one all-reduce
averages over the ranks (`GradientReducer`); then every rank clips by the
global norm and updates its masters alike. The loss is then the mean over
the global batch, and drop-path masks are the global batch's rows
(`models.common.shard_drop_path`).

On a mesh with `spatial` and `tensor` lines (`parallel/model_parallel.py`)
the masters stay full fp32 tensors on every rank, as JAX's replicated
state: they are taken before `shard_model` slices the module. Each rank
runs its rows' D slab on its slices, the loss sums its volume statistics
over the spatial line (the losses' `spatial=`), and each rank's backward
yields its share of the row's one loss gradient
(`parallel.collectives.AxisShard`). `GradientReducer` assembles the
masters' gradients from them: the spatial line's shares summed, the
tensor line's slices gathered, then the mean over the data line. Every
rank then clips and updates the same full masters, and `TrainState.copy_to`
writes this rank's slices of them into the module.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from waveformer_tpu_torch.models.common import shard_drop_path
from waveformer_tpu_torch.parallel.collectives import AxisShard
from waveformer_tpu_torch.parallel.mesh import Mesh, depth_slab
from waveformer_tpu_torch.parallel.model_parallel import is_sharded
from waveformer_tpu_torch.parallel.spatial import gather_depth
from waveformer_tpu_torch.parallel.tensor_sharding import rows, shard_tensor, split_dim
from waveformer_tpu_torch.training.schedules import Schedule, constant_schedule
from waveformer_tpu_torch.utils.profiling import span


@dataclass
class Optimizer:
    """Global-norm clip then AdamW, with the reference's defaults."""

    schedule: Schedule
    weight_decay: float = 1e-2
    grad_clip_norm: Optional[float] = 12.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class AdamWState:
    """optax `ScaleByAdamState`: the update count and fp32 first and second
    moments, one per master."""

    def __init__(self, params: List[torch.Tensor]):
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               tx: Optimizer, lr: float) -> None:
        """One AdamW step on `params` in place, as optax computes it."""
        self.count += 1
        # (1 - b)·g + b·m, rounded where optax rounds
        mu = torch._foreach_mul(grads, 1 - tx.b1)
        torch._foreach_add_(mu, torch._foreach_mul(self.mu, tx.b1))
        nu = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(nu, 1 - tx.b2)
        torch._foreach_add_(nu, torch._foreach_mul(self.nu, tx.b2))
        self.mu, self.nu = mu, nu
        bc1 = float(1 - np.float32(tx.b1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(tx.b2) ** np.float32(self.count))
        mu_hat = torch._foreach_div(self.mu, np.float32(bc1).item())
        denom = torch._foreach_div(self.nu, np.float32(bc2).item())
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, tx.eps)
        upd = torch._foreach_div(mu_hat, denom)
        if tx.weight_decay:
            torch._foreach_add_(upd, params, alpha=tx.weight_decay)
        torch._foreach_add_(params, upd, alpha=-lr)


def make_optimizer(
    lr: Union[float, Schedule] = 1e-4,
    weight_decay: float = 1e-2,
    grad_clip_norm: Optional[float] = 12.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Optimizer:
    """AdamW with global-norm clipping (reference defaults)."""
    schedule = lr if callable(lr) else constant_schedule(float(lr))
    return Optimizer(schedule, weight_decay, grad_clip_norm, b1, b2, eps)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient, as a device scalar (`optax.global_norm`)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """`optax.clip_by_global_norm` in place: (g / norm)·max_norm where norm
    ≥ max_norm, g unchanged below it (divided and multiplied by 1). No host
    synchronisation."""
    below = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, torch.full_like(norm, max_norm)))


def master_params(model: torch.nn.Module,
                  compute_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The fp32 masters of a module that still holds its fp32 weights, by
    name; then the module is cast to `compute_dtype` (its
    `set_compute_dtype`). A parameter that stays fp32 is its own master
    (`shard_model` then puts a new parameter with this rank's slice in the
    module and leaves the full master be); any other keeps the fp32 values
    it had before the cast. So a bf16 module's masters are its fp32
    weights, as the JAX package's fp32 params are, and not their bf16
    rounding."""
    weights = {}
    for n, p in model.named_parameters():
        if p.dtype != torch.float32:
            raise TypeError(f"{n} is {p.dtype}: build the module in fp32 and let "
                            "the masters be taken before it is cast")
        # shares the fp32 storage, which the cast below leaves to it
        weights[n] = p.detach()
    model.set_compute_dtype(compute_dtype)
    return {n: p if p.dtype == torch.float32 else weights[n]
            for n, p in model.named_parameters()}


class TrainState:
    """Step count, fp32 master parameters (by the module's parameter names;
    what checkpoints save) and the AdamW state over them."""

    def __init__(self, step: int, params: Dict[str, torch.Tensor],
                 opt_state: AdamWState, tx: Optimizer):
        self.step = step
        self.params = params
        self.opt_state = opt_state
        self.tx = tx

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor], tx: Optimizer) -> "TrainState":
        return cls(0, params, AdamWState(list(params.values())), tx)

    def apply_gradients(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Clip `grads` (fp32, in the masters' order, modified in place),
        take one AdamW step on the masters at `schedule(step)` and count it.
        Returns the unclipped global norm as a device scalar."""
        norm = global_norm(grads)
        if self.tx.grad_clip_norm is not None:
            clip_by_global_norm(grads, self.tx.grad_clip_norm, norm)
        with torch.no_grad():
            self.opt_state.update(list(self.params.values()), grads, self.tx,
                                  self.tx.schedule(self.step))
        self.step += 1
        return norm

    def moments(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """AdamW's first and second moments by parameter name."""
        names = list(self.params)
        return dict(zip(names, self.opt_state.mu)), dict(zip(names, self.opt_state.nu))

    def load(self, params: Mapping[str, torch.Tensor], mu: Mapping[str, torch.Tensor],
             nu: Mapping[str, torch.Tensor], step: int) -> None:
        """Restore masters, moments and the step count in place (the
        update count is the step count: one update a step)."""
        with torch.no_grad():
            for i, (n, p) in enumerate(self.params.items()):
                p.copy_(params[n])
                self.opt_state.mu[i].copy_(mu[n])
                self.opt_state.nu[i].copy_(nu[n])
        self.opt_state.count = self.step = int(step)

    def copy_to(self, model: torch.nn.Module, tensor: Optional[AxisShard] = None) -> None:
        """Write the masters into the module's parameters where they are
        copies (parameters in another dtype, or this tensor rank's slices
        of them)."""
        with torch.no_grad():
            for n, p in model.named_parameters():
                m = self.params[n]
                if m.shape != p.shape:
                    m = shard_tensor(n, m, tensor)
                if m.data_ptr() != p.data_ptr() or m.dtype != p.dtype:
                    p.copy_(m)


LINES = ("spatial", "tensor", "data")


class GradientReducer:
    """Every rank's fp32 gradients made the masters' gradients of the
    global batch, in one flat buffer and one collective a line, in order:

      1. `spatial`: the sum over the line (each slab's share);
      2. `tensor`: a sliced parameter's slices (the keys
         `tensor_sharding.RULES` names) gathered into the full tensor in
         the order of `tensor_sharding.rows`; a replicated parameter's
         gradient, which every tensor rank computes alike, taken from
         tensor rank 0 in the same buffer (on the card an atomic sum may
         round it differently on another rank, and the masters must stay
         equal);
      3. `data`: the mean over the line, with the loss.

    With `replicated` (the SSL step: the spatial and tensor ranks of a row
    run the same rows on the whole model) steps 1 and 2 take line rank 0's
    gradients. Every rank passes the same tensors in the same order (a
    parameter the loss does not reach has a zero gradient, never a missing
    one). On the card the last 64 collectives of each line are bracketed
    by CUDA events (`device_ms`); `bytes` counts what each line moved."""

    def __init__(self, mesh: Mesh, replicated: bool = False):
        self.mesh = mesh
        self.replicated = replicated
        self.events = {line: collections.deque(maxlen=64) for line in LINES}
        self.bytes = dict.fromkeys(LINES, 0)
        self._order: Dict[Tuple[str, int], torch.Tensor] = {}

    def _run(self, line: str, flat: torch.Tensor, group, src: Optional[int] = None) -> None:
        """All-reduce `flat` over `group` in place (broadcast it from line
        rank `src`), timed and counted as `line`'s."""
        timed = flat.is_cuda
        if timed:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        if src is None:
            dist.all_reduce(flat, group=group)
        else:
            dist.broadcast(flat, dist.get_global_rank(group, src), group=group)
        if timed:
            end.record()
            self.events[line].append((start, end))
        self.bytes[line] += flat.numel() * flat.element_size()

    @staticmethod
    def _split(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
        parts = torch.split(flat, [g.numel() for g in like])
        return [p.view_as(g) for p, g in zip(parts, like)]

    def _line(self, line: str, grads: List[torch.Tensor], shard: AxisShard) -> List[torch.Tensor]:
        flat = torch.cat([g.reshape(-1) for g in grads])
        self._run(line, flat, shard.group, 0 if self.replicated else None)
        return self._split(flat, grads)

    def _full_order(self, name: str, n: int, t: AxisShard, device) -> torch.Tensor:
        """Where each row of the slices concatenated in rank order goes in
        the full tensor's split dim (of extent n)."""
        key = (name, n)
        if key not in self._order:
            cat = torch.cat([rows(name, n, r, t.size) for r in range(t.size)])
            self._order[key] = torch.argsort(cat).to(device)
        return self._order[key]

    def _tensor(self, grads: List[torch.Tensor], masters: Mapping[str, torch.Tensor]
                ) -> List[torch.Tensor]:
        t = self.mesh.tensor
        names = list(masters)
        sliced = [i for i, n in enumerate(names) if split_dim(n) is not None]
        kept = [i for i, n in enumerate(names) if split_dim(n) is None]
        empty = grads[0].reshape(-1)[:0]
        part, rest = (torch.cat([grads[i].reshape(-1) for i in idx] + [empty])
                      for idx in (sliced, kept))
        k = part.numel()
        flat = part.new_zeros(t.size * k + rest.numel())
        flat[t.rank * k:(t.rank + 1) * k] = part
        if t.rank == 0:
            flat[t.size * k:] = rest
        self._run("tensor", flat, t.group)
        out = list(grads)
        slots = flat[:t.size * k].view(t.size, k)
        off = 0
        for i in sliced:
            g, name = grads[i], names[i]
            dim = split_dim(name)
            n = masters[name].shape[dim]
            joined = torch.cat([slots[r, off:off + g.numel()].view_as(g) for r in range(t.size)],
                               dim)
            out[i] = joined.index_select(dim, self._full_order(name, n, t, g.device))
            off += g.numel()
        for i, v in zip(kept, self._split(flat[t.size * k:], [grads[i] for i in kept])):
            out[i] = v
        return out

    def __call__(self, grads: List[torch.Tensor], loss: torch.Tensor,
                 masters: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """(the masters' gradients, views of the buffers; the averaged
        loss). `masters` (names and full shapes, in the gradients' order)
        is needed on a tensor line."""
        mesh = self.mesh
        if mesh.spatial is not None:
            grads = self._line("spatial", grads, mesh.spatial)
        if mesh.tensor is not None:
            grads = (self._line("tensor", grads, mesh.tensor) if self.replicated
                     else self._tensor(grads, masters))
        loss = loss.detach().float().reshape(1)
        if mesh.group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads] + [loss])
            self._run("data", flat, mesh.group)
            flat.div_(mesh.size)
            grads, loss = self._split(flat[:-1], grads), flat[-1:]
        return grads, loss[0]

    def device_ms(self, line: str = "data") -> List[float]:
        """Device ms of each kept collective of `line` (waits for the
        device)."""
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events[line]]


def make_reducer(mesh: Optional[Mesh], replicated: bool = False) -> Optional[GradientReducer]:
    """The step's `GradientReducer`, or None where nothing communicates."""
    if mesh is None or (mesh.group is None and mesh.spatial is None and mesh.tensor is None):
        return None
    return GradientReducer(mesh, replicated)


def make_train_step(
    model: torch.nn.Module,
    loss_fn: Callable[..., torch.Tensor],
    mesh: Optional[Mesh] = None,
) -> Callable:
    """`step(state, batch, generator=None) -> (state, metrics)`: forward in
    the module's dtype (`generator` draws its drop-path masks), loss,
    backward, fp32 gradients, clip, AdamW on the masters, masters back into
    the module. `metrics` holds device scalars: the loss and the unclipped
    gradient norm.

    With a mesh that has a group, `batch` is this rank's rows of the
    global batch (and its D slab on a spatial line, `shard_batch`), every
    rank seeds `generator` alike, and the gradients and the loss are
    assembled over the lines before the clip (the step's `reducer`); the
    module's drop paths draw the global batch's masks. On a spatial or
    tensor line the module must be armed by `shard_model` (after the
    state's masters were taken), and on a spatial line `loss_fn` is called
    with `spatial=` the line, over which it sums its volume statistics (the
    port's losses take it).

    While a `torch.profiler` runs, the forward (model and loss) is the
    span `train_step.forward`, with device events (`utils.profiling`);
    `backward_and_update` adds `train_step.backward` and
    `train_step.optimizer`."""
    named = dict(model.named_parameters())
    reducer = make_reducer(mesh)
    kw = {}
    if reducer is not None:
        if not is_sharded(model, mesh):
            raise ValueError(f"mesh {mesh.shape} splits the model: arm it with "
                             "shard_model(model, mesh) once its masters are taken")
        shard_drop_path(model, mesh.rank, mesh.size)
        if mesh.spatial is not None:
            kw["spatial"] = mesh.spatial

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
        with span("train_step.forward", device=True):
            logits = model(batch["data"], generator=generator)
            loss = loss_fn(logits, batch["seg"], **kw)
        norm, loss = backward_and_update(state, loss, named, model, reducer)
        return state, {"loss": loss, "grad_norm": norm}

    step.reducer = reducer
    return step


def backward_and_update(state: TrainState, loss: torch.Tensor,
                        named: Dict[str, torch.nn.Parameter],
                        model: torch.nn.Module,
                        reducer: Optional[GradientReducer] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of `loss` into the module's parameters `named`, their
    fp32 gradients in the masters' order (assembled over the mesh's lines
    by `reducer`, with the loss), one optimizer step on the masters and the
    masters back into the module. Returns the unclipped global norm and
    the (averaged) loss, detached, as device scalars. The backward with the
    gradients' list, and the rest, are the spans `train_step.backward` and
    `train_step.optimizer` (`utils.profiling.span`, with device events)."""
    with span("train_step.backward", device=True):
        for p in named.values():
            p.grad = None
        loss.backward()
        # a parameter the loss does not reach gets zeros, as its JAX gradient is
        grads = [named[n].grad.float() if named[n].grad is not None
                 else torch.zeros_like(named[n], dtype=torch.float32) for n in state.params]
        for p in named.values():
            p.grad = None
    loss = loss.detach()
    with span("train_step.optimizer", device=True):
        tensor = None
        if reducer is not None:
            grads, loss = reducer(grads, loss, state.params)
            tensor = reducer.mesh.tensor
        norm = state.apply_gradients(grads)
        state.copy_to(model, tensor)
    return norm, loss


def make_eval_step(model: torch.nn.Module, mesh: Optional[Mesh] = None) -> Callable:
    """`step(image) -> logits`: a forward with no autograd record. On a
    spatial line `image` holds this rank's rows, whole along D: the step
    runs the module on this rank's D slab and joins the logits."""
    axis = 2 if getattr(model, "io_layout", "channels_last") == "channels_first" else 1

    def step(image: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            if mesh is None or mesh.spatial is None:
                return model(image)
            return gather_depth(model(depth_slab(mesh, image, axis)), mesh.spatial, axis)

    return step
