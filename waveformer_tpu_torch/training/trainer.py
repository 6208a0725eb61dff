"""Training engine on one CUDA device.

Port of `waveformer_tpu/training/trainer.py` (reference
`light_training/trainer.py:25-516`, `class Trainer`), with the same
constructor arguments and hooks:

  * the epoch structure of the reference: `num_steps_per_epoch` steps,
    validation every `val_every` epochs on `val_patches_per_epoch` patches,
    TensorBoard/JSONL scalars, best/final params `.npz` checkpoints in the
    JAX package's format and a periodic full state every 100th epoch
    (`3_train.py:150-188`), with auto-resume from the latest periodic state;
  * the step (`training.state.make_train_step`): the module forward in its
    compute dtype, the loss, the backward through the kernels'
    `autograd.Function`s, fp32 gradients, the optax-form clip and AdamW on
    fp32 masters, the masters back into the module;
  * batches from `data.pipeline.PrefetchLoader` (channels-last numpy), put
    in pinned host memory and uploaded with `non_blocking=True`;
  * losses read back only `loss_readback_window` steps late, since
    `.item()` synchronises the host with the device;
  * drop-path masks from a generator on the device, seeded from
    (seed, global_step) where the JAX trainer folds the step into its key.

With a `mesh` (`parallel/mesh.py`), where the JAX trainer shards the
batch over a device mesh's data axis, the trainer is one process of a data
group, one per card (the reference's DDP): `batch_size` is the global
batch, of which each rank's `PrefetchLoader` draws its share from its own
seed (seed + rank); the step averages the fp32 gradients over the ranks
(`make_train_step(mesh=...)`); the masters are broadcast from rank 0 at
the start and after a resume; the validation patches are split over the
ranks and their dice rows gathered (`gather_metrics`); rank 0 alone
writes logs, TensorBoard scalars and checkpoints, and every rank waits
for the others before `train()` returns.

On a mesh with `spatial` and `tensor` lines (JAX's `Trainer` takes any
`(data, spatial, tensor)` mesh) the masters are taken from the whole
module and `shard_model` then slices it; the rank at spatial and tensor
coordinate 0 of each data row draws the row's batches and broadcasts them
over its lines, every rank cuts its D slab, and the step assembles the
gradients over every line (`make_train_step`). Patch validation runs the
sharded forward and joins the logits along D; full-volume validation runs
on the rank at (0, 0, 0) alone, on an unsharded copy of the module loaded
from the masters, as JAX runs it on device 0. The masters and moments are
full on every rank, so checkpoints are written as on a data mesh.

The model is built by the caller (`scripts/train.py` through
`create_waveformer`) on the device it trains on; its current weights are
the initial masters. The caller builds it in fp32; the trainer casts it to
`compute_dtype` once those fp32 weights (or a checkpoint that
`load_params` put there before `train()`) have become the masters.

Subclasses override `training_loss` / `validation_step` /
`validation_end` like the reference's hooks (`trainer.py:483-493`).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from waveformer_tpu_torch.data.pipeline import PrefetchLoader
from waveformer_tpu_torch.parallel.collectives import gather_metrics
from waveformer_tpu_torch.parallel.mesh import Mesh, depth_slab, replicate
from waveformer_tpu_torch.parallel.model_parallel import shard_model
from waveformer_tpu_torch.training.checkpoint import (
    CheckpointManager,
    checkpoint_state_dict,
    checkpoint_tree,
)
from waveformer_tpu_torch.training.losses import dice_ce_loss
from waveformer_tpu_torch.training.schedules import make_schedule
from waveformer_tpu_torch.training.state import (
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
    master_params,
)
from waveformer_tpu_torch.utils.logger import SummaryWriter, get_logger


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed for (seed, step), the counterpart of
    `jax.random.fold_in(PRNGKey(seed), step)`."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def upload(a: np.ndarray, device: torch.device, dtype=np.float32) -> torch.Tensor:
    """A host array on `device` in `dtype`, through pinned memory and a
    non-blocking copy on a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Trainer:
    """Patch-based segmentation trainer."""

    def __init__(
        self,
        model: torch.nn.Module,
        max_epochs: int = 1000,
        batch_size: int = 4,
        val_every: int = 2,
        num_steps_per_epoch: int = 250,
        val_patches_per_epoch: int = 100,
        patch_size: Sequence[int] = (128, 128, 128),
        lr: float = 1e-4,
        weight_decay: float = 1e-2,
        grad_clip_norm: float = 12.0,
        scheduler: Optional[str] = None,
        warmup_epochs: float = 0.0,
        logdir: str = "./logs",
        model_name: str = "waveformer",
        mesh: Optional[Mesh] = None,
        num_workers: int = 12,
        cache_size: int = 6,
        # "train_fast": the nnUNet stack with the native OpenMP order-1
        # spatial resample (vs scipy order-3), the JAX trainer's default
        augmentation: str = "train_fast",
        label_mode: str = "brats",
        num_classes: int = 4,
        seed: int = 42,
        resume: bool = True,
        # every `full_val_every` epochs, sliding-window inference on
        # `full_val_cases` whole validation volumes (0 disables)
        full_val_every: int = 0,
        full_val_cases: int = 2,
        # the dtype the module computes in, from train() on
        compute_dtype: torch.dtype = torch.float32,
    ):
        self.model = model
        self.compute_dtype = compute_dtype
        self.device = next(model.parameters()).device
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        # the mesh's model-parallel lines (None where it has none)
        self.spatial = None if mesh is None else mesh.spatial
        self.tensor = None if mesh is None else mesh.tensor
        self.model_parallel = self.spatial is not None or self.tensor is not None
        # the rank that draws its data row's batches
        self.row_lead = mesh is None or mesh.coords[1:] == (0, 0)
        # the unsharded module of full-volume validation at (0, 0, 0) on a
        # model-parallel mesh
        self._full_model: Optional[torch.nn.Module] = None
        if mesh is not None and batch_size % mesh.size:
            raise ValueError(f"global batch {batch_size} does not split over "
                             f"{mesh.size} processes")
        self.max_epochs = max_epochs
        self.batch_size = batch_size
        self.val_every = val_every
        self.num_steps_per_epoch = num_steps_per_epoch
        self.val_patches_per_epoch = val_patches_per_epoch
        self.patch_size = tuple(patch_size)
        self.logdir = logdir
        self.model_name = model_name
        self.num_workers = num_workers
        self.cache_size = cache_size
        self.augmentation = augmentation
        self.label_mode = label_mode
        self.num_classes = num_classes
        self.seed = seed
        self.resume = resume
        self.log = get_logger()

        total_steps = max_epochs * num_steps_per_epoch
        warmup_steps = int(warmup_epochs * num_steps_per_epoch)
        self.schedule = make_schedule(scheduler, lr, total_steps, warmup_steps)
        self.tx = make_optimizer(lr=self.schedule, weight_decay=weight_decay,
                                 grad_clip_norm=grad_clip_norm)

        self.global_step = 0
        self.epoch = 0
        self.best_mean_dice = 0.0
        self.writer: Optional[SummaryWriter] = None
        self.ckpt = CheckpointManager(os.path.join(logdir, "model")) if self.is_main else None
        self._train_step = None
        self._eval_step = make_eval_step(model, mesh)
        self._generator = torch.Generator(device=self.device)
        self.full_val_every = full_val_every
        self.full_val_cases = full_val_cases
        self._full_val_inferer = None
        # per training epoch: (steps, seconds, seconds waiting on the loader)
        self.epoch_times: List[Tuple[int, float, float]] = []

    # ------------------------------------------------------------------ #
    # hooks (reference `trainer.py:483-493`)
    # ------------------------------------------------------------------ #
    def training_loss(self, logits, batch, spatial=None) -> torch.Tensor:
        """The loss of this rank's logits; `spatial` the mesh's spatial line,
        over which the volume's sums are summed (None without one)."""
        return dice_ce_loss(logits, batch["seg"], spatial=spatial)

    def convert_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """Label map (B,...,1) → (B, K, ...) fp32 binary stack for validation
        dice. `label_mode='brats'`: TC/WT/ET regions (`3_train.py:104-112`);
        `'multiclass'`: one binary channel per foreground class."""
        lab = labels[..., 0]
        if self.label_mode == "brats":
            tc = (lab == 1) | (lab == 3)
            wt = tc | (lab == 2)
            et = lab == 3
            return torch.stack([tc, wt, et], dim=1).float()
        return torch.stack([lab == c for c in range(1, self.num_classes)], dim=1).float()

    def validation_step(self, params, batch) -> np.ndarray:
        """Per-patch per-class dice (`3_train.py:132-148`), NaN where the
        class is absent from both prediction and ground truth, so absent
        classes are filtered from the epoch mean rather than counted as 1.0
        (`light_training/trainer.py:240-269`). `params` is the state's
        masters, which the module holds after every step; it stays in the
        hook's signature as in the JAX trainer. `batch` holds this rank's
        rows, whole volumes on a spatial line too (the eval step cuts the
        slab and joins the logits)."""
        logits = self._eval_step(batch["data"])
        pred = torch.argmax(logits, dim=-1)[..., None]
        pred_c = self.convert_labels(pred)
        gt_c = self.convert_labels(batch["seg"].long())
        axes = tuple(range(2, pred_c.ndim))
        inter = torch.sum(pred_c * gt_c, dim=axes)
        ps = torch.sum(pred_c, dim=axes)
        gs = torch.sum(gt_c, dim=axes)
        both_empty = (ps == 0) & (gs == 0)
        dice = torch.where(both_empty, torch.full_like(ps, float("nan")),
                           2 * inter / (ps + gs + 1e-8))
        return dice.cpu().numpy()  # (B, K), NaN = class absent everywhere

    def validation_end(self, mean_dice_per_class: np.ndarray):
        """Best/final/periodic checkpoint logic (`3_train.py:150-188`)."""
        if self.label_mode == "brats":
            names = ["tc", "wt", "et"][: len(mean_dice_per_class)]
        else:
            names = [f"class{c}" for c in range(1, len(mean_dice_per_class) + 1)]
        mean_dice = float(np.mean(mean_dice_per_class))
        for n, v in zip(names, mean_dice_per_class):
            self.log_scalar(f"{n}_dice", float(v), self.epoch)
        self.log_scalar("mean_dice", mean_dice, self.epoch)
        improved = mean_dice > self.best_mean_dice
        if improved:
            self.best_mean_dice = mean_dice
        if self.ckpt is None:  # not rank 0: it writes nothing
            return
        params = checkpoint_tree(self.model, self.state.params)
        if improved:
            self.ckpt.save_best(params, mean_dice, self.epoch, self.model_name)
            self.log.info(f"epoch {self.epoch}: new best mean dice {mean_dice:.4f}")
        self.ckpt.save_final(params, mean_dice, self.epoch, self.model_name)
        if (self.epoch + 1) % 100 == 0:
            self.ckpt.save_state(self.state, self.epoch, extra={"mean_dice": mean_dice})

    # ------------------------------------------------------------------ #
    def log_scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def _init_state(self) -> TrainState:
        return TrainState.create(master_params(self.model, self.compute_dtype), self.tx)

    def _resume_epoch(self) -> int:
        """The epoch of the latest periodic state, which rank 0 loads into
        the state, or -1 where there is none; the same on every rank."""
        epoch = -1
        if self.resume and self.ckpt is not None and self.ckpt.latest_checkpoint() is not None:
            path, epoch = self.ckpt.latest_checkpoint()
            self.state = self.ckpt.load_state(self.state, path)
            self.state.copy_to(self.model, self.tensor)
            self.log.info(f"resumed from {path} at epoch {epoch + 1}")
        if self.mesh is not None:
            e = torch.tensor([epoch], device=self.mesh.device)
            epoch = int(replicate(self.mesh, [e])[0])
        return epoch

    def _broadcast_state(self) -> None:
        """The masters, moments and step count of the rank at (0, 0, 0) on
        every rank, and the masters (this rank's slices) in the module."""
        mu, nu = self.state.moments()
        replicate(self.mesh, [*self.state.params.values(), *mu.values(), *nu.values()])
        step = torch.tensor([self.state.step], device=self.mesh.device)
        self.state.opt_state.count = self.state.step = int(replicate(self.mesh, [step])[0])
        self.state.copy_to(self.model, self.tensor)

    # ------------------------------------------------------------------ #
    def train(self, train_ds, val_ds) -> float:
        """Run the full loop; returns best mean dice."""
        self.writer = SummaryWriter(self.logdir) if self.is_main else None
        # each rank draws its share of the global batch from its own seed
        rank, world = (0, 1) if self.mesh is None else (self.mesh.rank, self.mesh.size)
        local_batch = self.batch_size // world
        train_loader = PrefetchLoader(
            train_ds,
            steps_per_epoch=self.num_steps_per_epoch,
            patch_size=self.patch_size,
            batch_size=local_batch,
            transform=self.augmentation,
            num_workers=self.num_workers,
            cache_size=self.cache_size,
            seed=self.seed + rank,
        )
        n_val_batches = max(1, self.val_patches_per_epoch // self.batch_size)
        val_loader = PrefetchLoader(
            val_ds,
            steps_per_epoch=n_val_batches,
            patch_size=self.patch_size,
            batch_size=local_batch,
            transform="val",
            num_workers=0,
            seed=self.seed + 1 + rank,
        )

        self.state = self._init_state()
        if self.model_parallel:
            if self.is_main:
                self._full_model = copy.deepcopy(self.model)
            shard_model(self.model, self.mesh)
        n_params = sum(int(p.numel()) for p in self.state.params.values())
        self.log.info(f"model {self.model_name}: {n_params:,} params; device {self.device}"
                      + ("" if self.mesh is None else f"; mesh {self.mesh.shape}"))

        start_epoch = self._resume_epoch() + 1
        if self.mesh is not None:
            self._broadcast_state()
        self.global_step = self.state.step

        self._train_step = make_train_step(
            self.model, lambda logits, seg, **kw: self.training_loss(logits, {"seg": seg}, **kw),
            mesh=self.mesh)

        try:
            for self.epoch in range(start_epoch, self.max_epochs):
                t0 = time.time()
                self.model.train()
                epoch_loss, wait_s = self._train_epoch(train_loader)
                self.model.eval()
                dt = time.time() - t0
                self.epoch_times.append((self.num_steps_per_epoch, dt, wait_s))
                self.log_scalar("epoch_loss", epoch_loss, self.epoch)
                self.log_scalar("lr", float(self.schedule(self.global_step)), self.epoch)
                self.log.info(f"epoch {self.epoch}: loss {epoch_loss:.4f} ({dt:.1f}s, "
                              f"{self.num_steps_per_epoch / dt:.3f} steps/s, "
                              f"{wait_s / dt:.1%} waiting on the loader)")
                if (self.epoch + 1) % self.val_every == 0:
                    dices = self._validate(val_loader)
                    self.validation_end(dices)
                if (self.full_val_every and (self.epoch + 1) % self.full_val_every == 0
                        and (self.is_main or not self.model_parallel)):
                    self.full_volume_validation(val_ds)
        finally:
            self.model.eval()
            train_loader.shutdown()
            if self.writer is not None:
                self.writer.close()
        if self.mesh is not None:
            self.mesh.barrier()
        return self.best_mean_dice

    # ------------------------------------------------------------------ #
    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows on the device: the loader's `batch`, or on a
        model-parallel mesh the row lead's, broadcast over the spatial
        line, then the tensor line (`batch` is None off the lead)."""
        if batch is not None:
            out = {"data": upload(batch["data"], self.device, np.float32),
                   "seg": upload(batch["seg"], self.device, np.int32)}
        if not self.model_parallel:
            return out
        shapes = torch.zeros(10, dtype=torch.int64, device=self.mesh.device)
        if batch is not None:
            shapes[:] = torch.tensor(out["data"].shape + out["seg"].shape)
        lines = [line for line in (self.spatial, self.tensor) if line is not None]
        for line in lines:
            dist.broadcast(shapes, dist.get_global_rank(line.group, 0), group=line.group)
        if batch is None:
            shape = shapes.tolist()
            out = {"data": torch.empty(shape[:5], device=self.device),
                   "seg": torch.empty(shape[5:], dtype=torch.int32, device=self.device)}
        for line in lines:
            for t in out.values():
                dist.broadcast(t, dist.get_global_rank(line.group, 0), group=line.group)
        return out

    def _row_batches(self, loader, n: int):
        """The loader's `n` batches on the row lead, None elsewhere."""
        return iter(loader) if self.row_lead else iter([None] * n)

    # How many steps the host may run ahead of the device before it reads a
    # loss back: `.item()` every step would wait for the device and
    # serialise the loader's work against the step; a small window keeps
    # them overlapped while bounding the batches in flight.
    loss_readback_window: int = 4

    def _train_epoch(self, loader) -> Tuple[float, float]:
        """One epoch of steps; returns (mean loss, host seconds spent
        waiting for the loader's batches)."""
        losses: List[float] = []
        pending: List[Tuple[int, torch.Tensor]] = []  # (global_step, device loss)
        wait_s = 0.0

        def drain(limit: int):
            while len(pending) > limit:
                s, dev = pending.pop(0)
                loss = dev.item()
                losses.append(loss)
                self.log_scalar("training_loss", loss, s)

        it = self._row_batches(loader, self.num_steps_per_epoch)
        while True:
            t0 = time.perf_counter()
            batch = next(it, StopIteration)
            wait_s += time.perf_counter() - t0
            if batch is StopIteration:
                break
            b = self._device_batch(batch)
            if self.spatial is not None:
                b = depth_slab(self.mesh, b)
            self._generator.manual_seed(step_seed(self.seed, self.global_step))
            self.state, metrics = self._train_step(self.state, b, self._generator)
            pending.append((self.global_step, metrics["loss"]))
            self.global_step += 1
            drain(self.loss_readback_window)
        drain(0)
        return (float(np.mean(losses)) if losses else 0.0), wait_s

    def _validate(self, loader) -> np.ndarray:
        per_patch: List[np.ndarray] = []
        for batch in self._row_batches(loader, len(loader)):
            b = self._device_batch(batch)
            per_patch.append(self.validation_step(self.state.params, b))
        all_vals = np.concatenate(per_patch, axis=0)  # (N, K) with NaNs
        if self.mesh is not None and self.mesh.group is not None:
            rows = torch.from_numpy(all_vals).to(self.mesh.device)
            all_vals = gather_metrics(rows, self.mesh.group).cpu().numpy()
        # reference semantics: mean over non-NaN patches per class; a class
        # absent from every patch scores 0 (`light_training/trainer.py:240-269`)
        counts = np.sum(~np.isnan(all_vals), axis=0)
        sums = np.nansum(all_vals, axis=0)
        return np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)

    # ------------------------------------------------------------------ #
    def _inferer(self):
        from waveformer_tpu_torch.inference.sliding_window import SlidingWindowInferer

        if self._full_val_inferer is None:
            self._full_val_inferer = SlidingWindowInferer(
                roi_size=self.patch_size, sw_batch_size=2, overlap=0.5,
                mirror_axes=None, layout="channels_last")
        return self._full_val_inferer

    def _predict_volume(self, data) -> np.ndarray:
        """Argmax labels of a (C, D, H, W) volume by sliding-window
        inference with the current weights, no TTA."""
        vol = torch.from_numpy(np.array(np.asarray(data).transpose(1, 2, 3, 0), np.float32))
        model = self.model
        if self._full_model is not None:
            model = self._full_model
            self.state.copy_to(model)
        was_training = model.training
        model.eval()
        try:
            logits = self._inferer()(vol.to(self.device), model, self.num_classes)
        finally:
            model.train(was_training)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def full_volume_validation(self, val_ds, max_cases: Optional[int] = None
                               ) -> Optional[np.ndarray]:
        """Stitch-level validation: sliding-window inference on whole
        preprocessed validation volumes with the current weights, per-class
        full-volume dice logged as `full_{tc,wt,et}_dice`. Returns the
        per-class means, or None if no case ran."""
        n = min(len(val_ds), max_cases or self.full_val_cases)
        if n <= 0:
            return None
        per_case: List[np.ndarray] = []
        t0 = time.time()
        for i in range(n):
            item = val_ds[i]
            pred = self._predict_volume(item["data"])
            per_case.append(self._case_dice(pred, np.asarray(item["seg"])[0]))
        vals = np.stack(per_case)  # (n, K) with NaNs for absent classes
        counts = np.sum(~np.isnan(vals), axis=0)
        sums = np.nansum(vals, axis=0)
        per_class = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
        if self.label_mode == "brats":
            names = ["tc", "wt", "et"][: len(per_class)]
        else:
            names = [f"class{c}" for c in range(1, len(per_class) + 1)]
        for name, v in zip(names, per_class):
            self.log_scalar(f"full_{name}_dice", float(v), self.epoch)
        self.log.info(
            f"epoch {self.epoch}: full-volume dice "
            + " ".join(f"{k}={v:.4f}" for k, v in zip(names, per_class))
            + f" ({n} cases, {time.time() - t0:.1f}s)"
        )
        return per_class

    def _case_dice(self, pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
        """Per-class dice of one full volume, NaN where a class is absent
        from both (the reference's filtering convention)."""
        pred_c = self.convert_labels(torch.from_numpy(np.asarray(pred))[None, ..., None])
        gt_c = self.convert_labels(torch.from_numpy(np.asarray(gt, np.int64))[None, ..., None])
        pred_c, gt_c = pred_c[0].numpy(), gt_c[0].numpy()
        axes = tuple(range(1, pred_c.ndim))
        inter = np.sum(pred_c * gt_c, axis=axes)
        ps = np.sum(pred_c, axis=axes)
        gs = np.sum(gt_c, axis=axes)
        both_empty = (ps == 0) & (gs == 0)
        return np.where(both_empty, np.nan, 2 * inter / (ps + gs + 1e-8))

    # ------------------------------------------------------------------ #
    def validation_single_gpu(
        self, test_ds, predict_case: Optional[Callable] = None
    ) -> Tuple[Any, np.ndarray]:
        """Single-process full-case validation with the reference's
        aggregation contract (`trainer.py:216-269`): run the per-case
        validation step over the whole dataset, then NaN-aware-average the
        outputs, per component when the step returns a vector (per-class
        dice), scalar otherwise; a component that is NaN for every case
        averages to 0. Returns ``(mean_or_means, all_outputs)``.

        ``predict_case(item) -> float | sequence`` is the model-define
        hook; omitted, it is sliding-window inference with the module's
        current weights + per-class dice against the stored segmentation."""
        if self.mesh is not None and self.mesh.spec.size() > 1:
            raise RuntimeError(
                "validation_single_gpu is single-process by contract "
                "(reference refuses under DDP, trainer.py:217-219); use "
                "sharded inference instead")
        if predict_case is None:
            def predict_case(item):
                pred = self._predict_volume(item["data"])
                return self._case_dice(pred, np.asarray(item["seg"])[0])

        outputs = []
        for i in range(len(test_ds)):
            out = predict_case(test_ds[i])
            outputs.append(np.asarray(out, np.float64))
            self.log.info(f"validation case {i + 1}/{len(test_ds)}: {outputs[-1]}")
        all_outputs = np.stack(outputs)
        counts = np.sum(~np.isnan(all_outputs), axis=0)
        sums = np.nansum(all_outputs, axis=0)
        means = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
        if all_outputs.ndim == 1:
            return float(means), all_outputs
        return means, all_outputs

    def load_params(self, path: str):
        """Load a params `.npz` (`checkpoint_state_dict`'s form for the
        model) into the module and, when training has started, into the
        masters. Before `train()` the module is still fp32, so the masters
        it starts from are the checkpoint's arrays."""
        from waveformer_tpu_torch.training.checkpoint import load_params_npz

        sd = checkpoint_state_dict(self.model, load_params_npz(path))
        if hasattr(self, "state"):
            with torch.no_grad():
                for n, m in self.state.params.items():
                    m.copy_(sd[n])
            self.state.copy_to(self.model, self.tensor)
        else:
            self.model.load_state_dict(sd, strict=True)
