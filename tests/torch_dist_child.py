"""One rank of the port's data-parallel tests: a child process over gloo.

    python tests/torch_dist_child.py SUITE RANK WORLD WORKDIR

Joins a gloo group through `file://WORKDIR/rendezvous` (60 s timeout),
reads the inputs the test wrote to `WORKDIR/inputs.pt`, runs SUITE's cases
on the CPU and writes this rank's results to `WORKDIR/rank{RANK}.pt`. It
imports torch, numpy and the port only, never JAX; the tests compare its
results with the JAX package in their own process. Suites:

  * `parallel` (tests/test_torch_parallel.py): the collectives,
    `SyncBatchNorm`, the losses with a group, the data-parallel train and
    SSL steps, and `Trainer(mesh=...)` with a resume;
  * `scripts` (tests/test_torch_sharded.py): `scripts.predict --sharded on`
    and `scripts.train --multihost`.
"""

from __future__ import annotations

import os
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

if __name__ == "__main__":  # run as a script: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from waveformer_tpu_torch.parallel import collectives as pc  # noqa: E402
from waveformer_tpu_torch.parallel.mesh import (  # noqa: E402
    init_distributed, make_mesh, shard_batch)
from waveformer_tpu_torch.training import losses as tl  # noqa: E402

TIMEOUT = timedelta(seconds=60)
# the losses with a group: (function, keyword arguments), batch dice on
LOSS_GROUP_CASES = {
    "soft_dice_batch": ("soft_dice_loss", dict(batch_dice=True)),
    "soft_dice_batch_no_bg_squared": ("soft_dice_loss", dict(
        batch_dice=True, include_background=False, squared_pred=True)),
    "dice_ce_batch": ("dice_ce_loss", dict(batch_dice=True, lambda_dice=0.7, lambda_ce=1.3)),
    "DiceCELoss_batch": ("DiceCELoss", dict(batch_dice=True, lambda_dice=0.5)),
    "dice_bce_batch": ("dice_bce_loss", dict(batch_dice=True, weight_ce=0.8, weight_dice=1.2)),
    "dice_bce_batch_ignore": ("dice_bce_loss", dict(batch_dice=True, use_ignore_label=True)),
}


def loss_fn(module, name, kw, group_kw):
    """The loss `name` of `module` (the port's or JAX's losses) with its
    case's arguments and the group argument `group_kw`."""
    if name == "DiceCELoss":
        return getattr(module, name)(**kw, **group_kw)
    return lambda x, y: getattr(module, name)(x, y, **kw, **group_kw)


def _grad_case(fn, *xs):
    """fn(*xs) and the gradients of its sum for each x."""
    xs = [torch.tensor(x, requires_grad=True) for x in xs]
    out = fn(*xs)
    out.sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


def run_parallel(inp, mesh, workdir):
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.models.ssl import SSLViT
    from waveformer_tpu_torch.training import ssl as tssl
    from waveformer_tpu_torch.training.schedules import warmup_cosine_schedule
    from waveformer_tpu_torch.training.state import (
        TrainState, make_optimizer, make_train_step, master_params)
    from waveformer_tpu_torch.training.trainer import step_seed

    g, rows = mesh.group, lambda a: shard_batch(mesh, a)
    out = {"rank": mesh.rank, "size": mesh.size, "shape": mesh.shape}

    # collectives: values and the gradients of Σ_r of each rank's sum
    w = torch.from_numpy(rows(inp["mean_w"]))
    out["mean"] = _grad_case(lambda x: pc.cross_replica_mean(x, g) * w, rows(inp["mean_x"]))
    out["gather"] = _grad_case(lambda x: pc.all_gather_with_grad(x, g) ** 2,
                               rows(inp["gather_x"]))
    out["metrics"] = pc.gather_metrics(torch.from_numpy(rows(inp["metrics"])), g).numpy()

    # SyncBatchNorm: one training call, then one in eval mode
    bn = pc.SyncBatchNorm(inp["sbn_x"].shape[-1], g)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["sbn_weight"]))
        bn.bias.copy_(torch.from_numpy(inp["sbn_bias"]))
    x = torch.tensor(rows(inp["sbn_x"]), requires_grad=True)
    y = bn.train()(x)
    (y * torch.from_numpy(rows(inp["sbn_c"]))).sum().backward()
    with torch.no_grad():
        y_eval = bn.eval()(torch.from_numpy(rows(inp["sbn_x"])))
    out["sbn"] = {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
                  "weight_grad": bn.weight.grad.numpy(), "bias_grad": bn.bias.grad.numpy(),
                  "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy(),
                  "num_batches_tracked": int(bn.num_batches_tracked), "y_eval": y_eval.numpy()}

    # the losses with a group: this rank's value and its logits' gradient
    out["losses"] = {}
    for case, (name, kw) in LOSS_GROUP_CASES.items():
        target = inp["regions_ignore"] if kw.get("use_ignore_label") else (
            inp["regions"] if name == "dice_bce_loss" else inp["labels"])
        logits = torch.tensor(rows(inp["logits"]), requires_grad=True)
        loss = loss_fn(tl, name, kw, {"group": g})(logits, torch.from_numpy(rows(target)))
        loss.backward()
        out["losses"][case] = (float(loss.detach()), logits.grad.numpy())

    # the data-parallel train step, without and with drop path
    data, seg = inp["batch"]
    out["train"] = {}
    for tag, cfg in (("no_drop", inp["train_cfg"]), ("drop", inp["train_cfg_drop"])):
        model = create_waveformer(cfg, device="cpu").train()
        model.load_state_dict(inp["train_sd"], strict=True)
        state = TrainState.create(master_params(model), make_optimizer(lr=1e-4))
        step = make_train_step(model, tl.dice_ce_loss, mesh)
        batch = {"data": torch.from_numpy(rows(data)), "seg": torch.from_numpy(rows(seg))}
        gen = torch.Generator()
        metrics = []
        for i in range(2):
            gen.manual_seed(step_seed(0, i))
            state, m = step(state, batch, gen)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out["train"][tag] = {"metrics": metrics, "step": state.step,
                             "params": {k: v.detach().clone() for k, v in state.params.items()}}

    # the data-parallel SSL step
    model = SSLViT(**inp["ssl_cfg"]).train()
    model.load_state_dict(inp["ssl_sd"], strict=True)
    state = TrainState.create(dict(model.named_parameters()), make_optimizer(
        lr=warmup_cosine_schedule(1e-3, 1, 10), weight_decay=1e-5, grad_clip_norm=None))
    step = tssl.make_ssl_step(model, mesh=mesh)
    metrics = []
    for v1, v2 in inp["ssl_views"]:
        state, m = step(state, *(torch.from_numpy(rows(a)) for a in (v1, v2, inp["ssl_gt"])))
        metrics.append({k: float(m[k]) for k in ("loss", "contrast", "recon", "grad_norm")})
    out["ssl"] = {"metrics": metrics,
                  "params": {k: v.detach().clone() for k, v in state.params.items()}}

    out["trainer"] = run_trainer(inp, mesh, workdir)
    return out


def run_trainer(inp, mesh, workdir):
    """`Trainer(mesh=...)` for 2 epochs, then rank 0 writes a periodic
    state and a second trainer resumes from it for one more epoch. Rank 1's
    module starts from other weights: the broadcast from rank 0 must
    replace them."""
    from waveformer_tpu_torch.data.dataset import MedicalDataset
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.training.trainer import Trainer

    fullres = os.path.join(workdir, "fullres")
    names = sorted(f[:-4] for f in os.listdir(fullres) if f.endswith(".npz"))
    train_ds = MedicalDataset(fullres, names[:3], unpack=False)
    val_ds = MedicalDataset(fullres, names[3:], unpack=False)
    logdir = os.path.join(workdir, "trainer_logs")
    kw = dict(batch_size=2, val_every=1, num_steps_per_epoch=2, val_patches_per_epoch=4,
              patch_size=inp["trainer_cfg"]["img_size"], logdir=logdir, num_workers=0,
              augmentation="noaug", seed=3, mesh=mesh)
    out = {}
    model = create_waveformer(inp["trainer_cfg"], device="cpu", seed=mesh.rank)
    trainer = Trainer(model, max_epochs=2, resume=False, **kw)
    out["best"] = trainer.train(train_ds, val_ds)
    out["first"] = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    out["global_step"] = trainer.global_step
    out["wrote"] = trainer.writer is not None or trainer.ckpt is not None
    if mesh.is_main:
        trainer.ckpt.save_state(trainer.state, trainer.epoch)
    mesh.barrier()
    model = create_waveformer(inp["trainer_cfg"], device="cpu", seed=10 + mesh.rank)
    resumed = Trainer(model, max_epochs=3, resume=True, **kw)
    resumed.train(train_ds, val_ds)
    out["resumed"] = {k: v.detach().clone() for k, v in resumed.state.params.items()}
    out["resumed_epochs"] = len(resumed.epoch_times)
    out["resumed_step"] = resumed.global_step
    try:
        resumed.validation_single_gpu(val_ds)
        out["single_gpu_raised"] = False
    except RuntimeError:
        out["single_gpu_raised"] = True
    return out


def run_scripts(inp, mesh, workdir):
    """`scripts.predict --sharded on`, then `scripts.train --multihost`,
    each on the tree the test wrote, in the group this process joined."""
    from waveformer_tpu_torch.scripts import predict, train

    out = {"predict": predict.main(["--config", inp["predict_config"], "--device", "cpu",
                                    "--tta", "2", "--sharded", "on"])}
    out["predict_files"] = sorted(os.listdir(inp["prediction_dir"]))
    trainer = train.main(["--config", inp["train_config"], "--multihost", "--device", "cpu"])
    out["train"] = {"params": {k: v.detach().clone() for k, v in trainer.state.params.items()},
                    "global_step": trainer.global_step,
                    "wrote": trainer.writer is not None or trainer.ckpt is not None,
                    "mesh": trainer.mesh.shape}
    return out


SUITES = {"parallel": run_parallel, "scripts": run_scripts}


def main(suite: str, rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    init_distributed("cpu", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
                     timeout=TIMEOUT)
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        t0 = time.time()
        out = SUITES[suite](inp, make_mesh(), workdir)
        out["seconds"] = time.time() - t0
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
