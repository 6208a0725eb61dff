"""Kind `train`: the system's training step, `make_train_step(model,
dice_ce_loss, mesh)` on the module cast to the compute dtype over fp32
masters (`master_params`), as `Trainer` runs it, back to back on a
resident ring of batches. Step t draws its drop-path masks from a device
generator seeded with (seed, t), as `Trainer` seeds one per step. The
window runs steps until its seconds are up and reads the last loss back
before the clock stops.

On a cell of more than one card every rank runs this, as a job that
`torchrun` starts: the mesh is `make_mesh()` over the process group, every
rank on `data`, and the step's `GradientReducer` averages the fp32
gradients and the loss over the ranks before the clip. Each rank's ring
comes from the seed and its rank; the global batch is `batch` times the
ranks. Rank 0's clock paces the window, so every rank runs the same steps.

Set-up builds the one training object, drives it through its first
`CHECK_STEPS` steps on the ring's first batches (every row a different
one) and keeps what the check reads: each step's loss, the first
gradient as AdamW got it (its first moment after one step, over 1 − b1),
and the masters after the last of them. The window then goes on with the
same object. Once the window has closed and its peak has been read, the
same object takes one more step through the window's own call, from the
state the window left: its loss and the masters' change are kept, with
that state (masters, AdamW's moments and count).

The check makes the batches again from the seed and runs the reference's
steps from the same state dict, batches and masks, and the reference's one
step from the state the window left (there it follows the program from the
program's own state); on more than one card each rank runs its shard of
each global batch and the shards are summed, as DDP defines the step. The
numbers a cell compares (its limits name them), each the worst over its
items:
  loss_gap:   |loss − reference| / |reference| over the first steps;
  grad_gap:   |‖g‖ − ‖g_ref‖| / max(‖g_ref‖, median leaf's ‖g_ref‖) over
              the parameters, for the first gradient;
  change_gap: the same for each parameter's change over the first steps;
  last_loss_gap, last_change_gap: loss_gap and change_gap of the step
              after the window;
  rank_gap:   (more than one card) the largest difference of any rank's
              fp32 masters from rank 0's after that step: replicas that
              data parallelism keeps equal.
A parameter whose reference gradient (of the first step, or of the step
after the window) is under a thousandth of the median parameter's is left
out of the changes and the gradient (its gradient is zero but for
rounding, as for a bias before an InstanceNorm, and AdamW moves it by
±lr whatever the rounding).

Traffic keys: `batch` (a rank's), `ring` (batches, ≥ CHECK_STEPS),
`trace_units` (steps in a traced window).
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench import seeds
from port_bench.reference.lowp import fp8_round, plain_precision
from port_bench.reference.train import AdamW, run_steps, step_seed
from port_bench.serving import DTYPES
from port_bench.trace import LOSS_SPAN, Span

CHECK_STEPS = 3


def make_batches(ctx) -> List[Dict[str, torch.Tensor]]:
    """This rank's ring: unit-normal channels-last volumes with a
    class-dependent offset, and label maps from a smooth random field, each
    row with its own class proportions and a cube of every class."""
    t = ctx.traffic
    c, k, size = ctx.arch.io(ctx.config["network"])
    b, ring = int(t["batch"]), int(t["ring"])
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(seeds.derive(ctx.seed, "batches" if ctx.ranks.world == 1
                                 else f"batches.{ctx.ranks.rank}"))
    dev = ctx.device
    coarse = tuple(max(s // 16, 1) for s in size)
    field = torch.randn((ring * b, k, *coarse), generator=gen, device=dev)
    field = field + 1.5 * torch.randn((ring * b, k, 1, 1, 1), generator=gen, device=dev)
    field = F.interpolate(field, size=size, mode="trilinear", align_corners=False)
    labels = field.argmax(dim=1)
    cube = max(size[0] // 16, 1)
    for cls in range(k):
        labels[:, :cube, :cube, cls * cube:(cls + 1) * cube] = cls
    means = torch.randn((k, c), generator=gen, device=dev)
    data = torch.randn((ring * b, *size, c), generator=gen, device=dev) + 0.5 * means[labels]
    labels = labels.to(torch.int32).unsqueeze(-1)
    return [{"data": data[i * b:(i + 1) * b], "seg": labels[i * b:(i + 1) * b]}
            for i in range(ring)]


def half_batch_loss(loss_fn):
    """A planted fault: the loss of the batch's first half only."""
    def fn(logits, labels, **kw):
        h = max(logits.shape[0] // 2, 1)
        return loss_fn(logits[:h], labels[:h], **kw)
    return fn


class Workload:
    def __init__(self, ctx, loss_fault=None):
        from waveformer_tpu_torch.parallel.mesh import make_mesh
        from waveformer_tpu_torch.training.losses import dice_ce_loss
        from waveformer_tpu_torch.training.state import (
            TrainState, make_optimizer, make_train_step, master_params)

        self.ctx = ctx
        cfg, opt = ctx.config, ctx.config["optimizer"]
        model = ctx.arch.system(cfg["network"], torch.float32, ctx.device)
        model.load_state_dict(ctx.state_dict)
        model.train()
        tx = make_optimizer(opt["lr"], opt["weight_decay"], opt["grad_clip_norm"])
        self.state = TrainState.create(master_params(model, DTYPES[cfg["compute_dtype"]]), tx)
        self.loss = Span(LOSS_SPAN, loss_fault(dice_ce_loss) if loss_fault else dice_ce_loss)
        self.step = make_train_step(model, self.loss,
                                    make_mesh() if ctx.ranks.world > 1 else None)
        self.model = model
        self.batches = make_batches(ctx)
        self.gen = torch.Generator(device=ctx.device)
        self.drop_seed = seeds.derive(ctx.seed, "drop_path")
        self.done = 0
        self.expected = None
        losses = []
        for t in range(CHECK_STEPS):
            losses.append(self._one()["loss"])
            if t == 0:
                mu1 = [m.clone() for m in self.state.opt_state.mu]
        names = list(self.state.params)
        self.program = {
            "losses": [float(x) for x in losses],
            "grads": {n: m / (1 - tx.b1) for n, m in zip(names, mu1)},
            "params": {n: p.detach().clone() for n, p in self.state.params.items()},
        }

    def _one(self):
        self.gen.manual_seed(step_seed(self.drop_seed, self.state.step))
        batch = self.batches[self.done % len(self.batches)]
        self.done += 1
        return self.step(self.state, batch, self.gen)[1]

    def window(self, seconds=None, units=None):
        self.loss.calls = self.loss.rows = 0
        go = self.ctx.ranks.pace(seconds, units)
        t0 = time.perf_counter()
        n, m = 0, None
        while go(n):
            m = self._one()
            n += 1
        last = float(m["loss"])  # waits for every step of the window
        elapsed = time.perf_counter() - t0
        b = int(self.ctx.traffic["batch"]) * self.ctx.ranks.world
        ok = last == last and abs(last) != float("inf")
        out = {"attempted": n, "completed": n if ok else 0, "failed": 0 if ok else n,
               "elapsed_s": elapsed, "steps": n, "samples": n * b, "forwards": n,
               "patches": n * b}
        reducer = self.step.reducer
        if reducer is not None and self.ctx.device.type == "cuda":
            out["allreduce_ms"] = reducer.device_ms("data")[-n:]
        return out

    def release(self):
        """Take the step after the window, then free the system's state."""
        s = self.state
        names = list(s.params)
        before = {n: p.detach().clone() for n, p in s.params.items()}
        self.last = {"step": s.step, "index": self.done % len(self.batches),
                     "params": before, "count": s.opt_state.count,
                     "mu": dict(zip(names, (m.clone() for m in s.opt_state.mu))),
                     "nu": dict(zip(names, (v.clone() for v in s.opt_state.nu)))}
        self.last["loss"] = float(self._one()["loss"])
        self.last["change"] = {n: p.detach() - before[n] for n, p in s.params.items()}
        self.rank_gap = self.ctx.ranks.gap_to_rank0(
            torch.cat([p.detach().reshape(-1) for p in s.params.values()]))
        self.model = self.state = self.step = self.batches = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _expected(self) -> List[Dict[str, torch.Tensor]]:
        """This rank's ring, made again from the seed for the reference."""
        if self.expected is None:
            self.expected = make_batches(self.ctx)
        return self.expected

    def _shard(self):
        r = self.ctx.ranks
        return (r.rank, r.world, r.gather) if r.world > 1 else None

    def _reference(self, rounding=None) -> Dict:
        ctx, opt = self.ctx, self.ctx.config["optimizer"]
        model = ctx.arch.build(ctx.config["network"], ctx.device)
        model.load_state_dict(ctx.state_dict)
        if rounding is not None:
            ctx.arch.set_rounding(model, rounding)
        adamw = AdamW(list(model.parameters()), opt["lr"], opt["weight_decay"],
                      opt["grad_clip_norm"])
        with plain_precision():
            out = run_steps(model, self._expected()[:CHECK_STEPS], self.drop_seed, adamw,
                            ctx.arch, shard=self._shard())
        return {"losses": out["losses"], "grads": out["first_grads"],
                "params": {n: p.detach() for n, p in model.named_parameters()}}

    def _last_reference(self, rounding=None) -> Dict:
        """The reference's step from the state the window left."""
        ctx, opt, last = self.ctx, self.ctx.config["optimizer"], self.last
        model = ctx.arch.build(ctx.config["network"], ctx.device)
        model.load_state_dict(ctx.state_dict)
        if rounding is not None:
            ctx.arch.set_rounding(model, rounding)
        named = dict(model.named_parameters())
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(last["params"][n])
        adamw = AdamW(list(named.values()), opt["lr"], opt["weight_decay"],
                      opt["grad_clip_norm"])
        adamw.mu = [last["mu"][n].clone() for n in named]
        adamw.nu = [last["nu"][n].clone() for n in named]
        adamw.count = last["count"]
        with plain_precision():
            out = run_steps(model, [self._expected()[last["index"]]], self.drop_seed, adamw,
                            ctx.arch, first_step=last["step"], shard=self._shard())
        return {"loss": out["losses"][0], "grads": out["first_grads"],
                "change": {n: p.detach() - last["params"][n] for n, p in named.items()}}

    def check(self) -> Dict[str, float]:
        out = {**compare(self.program, self._reference(), self.ctx.state_dict),
               **compare_last(self.last, self._last_reference())}
        if self.ctx.ranks.world > 1:
            out["rank_gap"] = self.rank_gap
        return out

    def control(self) -> Dict[str, float]:
        """The check's numbers for the reference in float8 in the system's
        place, against the float32 reference."""
        first = compare(self._reference(fp8_round), self._reference(), self.ctx.state_dict)
        return {**first, **compare_last(self._last_reference(fp8_round), self._last_reference())}


def _kept(grads: Dict[str, torch.Tensor]):
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more, and the gradients' norms."""
    g_ref = {n: float(g.norm()) for n, g in grads.items()}
    med = statistics.median(g_ref.values())
    return [n for n in g_ref if g_ref[n] >= 1e-3 * med], g_ref


def _worst(kept, prog_norm, ref_norm):
    """The worst leaf's gap of norms, over the reference's norm or the
    median leaf's, whichever is larger; and that leaf."""
    m = statistics.median(ref_norm[n] for n in kept)
    gaps = {n: abs(prog_norm[n] - ref_norm[n]) / max(ref_norm[n], m, 1e-30) for n in kept}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def compare_last(prog: Dict, ref: Dict) -> Dict:
    """The numbers of the step after the window."""
    kept, _ = _kept(ref["grads"])
    c_prog = {n: float(prog["change"][n].norm()) for n in kept}
    c_ref = {n: float(ref["change"][n].norm()) for n in kept}
    gap, leaf = _worst(kept, c_prog, c_ref)
    return {"last_loss_gap": abs(prog["loss"] - ref["loss"]) / abs(ref["loss"]),
            "last_change_gap": gap, "worst_last_change_leaf": leaf}


def compare(prog: Dict, ref: Dict, init: Dict[str, torch.Tensor]) -> Dict:
    """The check's numbers, with the leaves that read worst."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    kept, g_ref = _kept(ref["grads"])
    g_prog = {n: float(prog["grads"][n].float().norm()) for n in kept}
    c_ref = {n: float((ref["params"][n] - init[n]).norm()) for n in kept}
    c_prog = {n: float((prog["params"][n] - init[n]).norm()) for n in kept}
    grad_gap, grad_leaf = _worst(kept, g_prog, g_ref)
    change_gap, change_leaf = _worst(kept, c_prog, c_ref)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "worst_grad_leaf": grad_leaf, "worst_change_leaf": change_leaf}
