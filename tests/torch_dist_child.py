"""One rank of the port's distributed tests: a child process over gloo.

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
    and `scripts.train --multihost`;
  * `model_parallel` (tests/test_torch_model_parallel.py): the toy network's
    forward on each mesh the test lists (`shard_model`, `shard_batch`,
    `gather_depth`), then, on a `spatial` line of all ranks, the depth
    primitives;
  * `train_model_parallel` (tests/test_torch_train_model_parallel.py): two
    train steps of the toy network on each mesh the test lists, the
    differentiable primitives' gradients in float64 on a `spatial` and a
    `tensor` line of all ranks, the losses on a `spatial` line, and (at 2
    ranks) the drop-path and checkpointing cases, `Trainer(mesh=...)` with a
    resume and `SSLTrainer(mesh=...)`.
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


def run_model_parallel(inp, mesh, workdir):
    """For each spec of `inp["specs"]`: this rank's place and lines, and the
    logits of its data rows gathered along D. Then the depth primitives on
    a spatial line of every rank, each on this rank's slab of its input."""
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.models.common import ConvCL, InstanceNormAffine
    from waveformer_tpu_torch.parallel import MeshSpec, shard_model, spatial
    from waveformer_tpu_torch.parallel.mesh import make_mesh as mesh_of

    ranks = lambda g: None if g is None else dist.get_process_group_ranks(g)
    out = {"meshes": {}}
    for spec in inp["specs"]:
        m = mesh_of(MeshSpec(*spec))
        model = create_waveformer(inp["cfg"], device="cpu")
        model.load_state_dict(inp["state_dict"], strict=True)
        shard_model(model, m)
        with torch.no_grad():
            y = model(torch.from_numpy(shard_batch(m, inp["x"])))
            full = spatial.gather_depth(y, m.spatial)
        out["meshes"][spec] = {
            "coords": m.coords, "is_main": m.is_main, "rank": m.rank, "size": m.size,
            "groups": [ranks(g) for g in (m.group, m.spatial_group, m.tensor_group)],
            "slab": tuple(y.shape), "logits": full.numpy(), "traffic": m.traffic.bytes,
            "params": {k: tuple(v.shape) for k, v in model.state_dict().items()}}

    s = mesh_of(MeshSpec(spatial=dist.get_world_size())).spatial
    mine = lambda a, axis=1: torch.from_numpy(np.split(a, s.size, axis)[s.rank].copy())
    prims = out["primitives"] = {}
    with torch.no_grad():
        x = mine(inp["halo_x"])
        prims["halo"] = {p: spatial.halo(x, s, p).numpy() for p in (1, 2)}
        for name, (cin, cout, groups) in inp["convs"].items():
            conv = ConvCL(cin, cout, 3, padding=1, groups=groups)
            conv.load_state_dict(inp["conv_sd"][name])
            conv.depth_shard = s
            prims[name] = conv(mine(inp["conv_x"][name])).numpy()
        prims["resize"] = {
            (name, dt): spatial.resize_trilinear(mine(inp["resize_x"][src]).to(dt), size, align,
                                                 s).float().numpy()
            for name, (src, size, align) in inp["resizes"].items()
            for dt in (torch.float32, torch.bfloat16)}
        x = mine(inp["norm_x"])
        norm = InstanceNormAffine(x.shape[-1])
        norm.load_state_dict(inp["norm_sd"])
        norm.depth_shard = s
        prims["instance_norm"] = spatial.instance_norm(x, 1e-5, s).numpy()
        prims["instance_norm_affine"] = norm(x).numpy()
        prims["mean_dhw"] = spatial.mean_dhw(x, s).numpy()
        prims["gather_cf"] = spatial.gather_depth(mine(inp["cf_x"], 2), s, axis=2).numpy()
    return out


def _train_steps(inp, spec, cfg, steps=2, dtype=torch.float32):
    """`steps` train steps of `cfg` on the mesh `spec`: the metrics, step
    1's masters' gradients as the step clips them, the masters after, this
    rank's gradients before the tensor line's assembly, and what the
    collectives moved. In float64 the module is its own master."""
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.parallel import MeshSpec, shard_model
    from waveformer_tpu_torch.parallel.mesh import make_mesh as mesh_of
    from waveformer_tpu_torch.training.state import (
        TrainState, make_optimizer, make_train_step, master_params)
    from waveformer_tpu_torch.training.trainer import step_seed

    mesh = mesh_of(MeshSpec(*spec))
    model = create_waveformer(cfg, device="cpu").train()
    model.load_state_dict(inp["state_dict"], strict=True)
    masters = (master_params(model) if dtype == torch.float32 else
               {n: p.detach() for n, p in model.to(dtype).named_parameters()})
    state = TrainState.create(masters, make_optimizer(lr=1e-4))
    shard_model(model, mesh)
    step = make_train_step(model, tl.dice_ce_loss, mesh)
    grads, local = [], []
    apply = state.apply_gradients
    state.apply_gradients = lambda g: (grads.append([t.clone() for t in g]), apply(g))[1]
    reducer = step.reducer
    if mesh.tensor is not None:
        assemble = reducer._tensor
        reducer._tensor = lambda g, m: (local.append([t.clone() for t in g]), assemble(g, m))[1]
    data, seg = inp["batch"]
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in shard_batch(mesh, {"data": data, "seg": seg}).items()}
    batch["data"] = batch["data"].to(dtype)
    gen = torch.Generator()
    metrics = []
    for i in range(steps):
        gen.manual_seed(step_seed(0, i))
        state, m = step(state, batch, gen)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    names = list(state.params)
    return {"coords": mesh.coords, "metrics": metrics,
            "grads": dict(zip(names, grads[0])),
            "local": dict(zip(names, local[0])) if local else None,
            "params": {k: v.detach().clone() for k, v in state.params.items()},
            "module": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "forward_bytes": mesh.traffic.bytes, "backward_bytes": mesh.traffic.backward_bytes,
            "assembly_bytes": dict(reducer.bytes)}


def _backward(fn, x, cot, *params):
    """fn(x) and the gradients of Σ fn(x)·cot for x and each of `params`."""
    x = x.clone().requires_grad_(True)
    y = fn(x)
    (y * cot).sum().backward()
    return y.detach(), [x.grad] + [p.grad.clone() for p in params]


def _primitive_grads(inp):
    """The differentiable primitives on this rank's share of float64
    inputs, on a `spatial` line of every rank, then on a `tensor` line of
    every rank: each output and its gradients for the test's cotangents."""
    from waveformer_tpu_torch.models.common import ConvCL
    from waveformer_tpu_torch.parallel import MeshSpec, spatial, tensor_sharding
    from waveformer_tpu_torch.parallel.mesh import make_mesh as mesh_of

    world = dist.get_world_size()
    s = mesh_of(MeshSpec(spatial=world)).spatial
    mine = lambda a, axis=1: torch.from_numpy(np.split(a, world, axis)[s.rank].copy())
    pr, out = inp["prims"], {}
    x, cot = mine(pr["x"]), mine(pr["cot"])
    for planes in (1, 2):
        c = torch.from_numpy(pr["halo_cot"][planes][s.rank])
        out["halo", planes] = _backward(lambda v: spatial.halo(v, s, planes), x, c)
    out["gather_own"] = _backward(
        lambda v: spatial.own_planes(torch.cumsum(spatial.gather_depth(v, s), 1) ** 2, s),
        x, cot)
    out["instance_norm"] = _backward(lambda v: spatial.instance_norm(v, 1e-5, s), x, cot)
    c = torch.from_numpy(pr["mean_cot"][s.rank])
    out["mean_dhw"] = _backward(lambda v: spatial.mean_dhw(v, s), x, c)
    for name, (cin, cout, groups) in pr["convs"].items():
        conv = ConvCL(cin, cout, 3, padding=1, groups=groups).double()
        conv.load_state_dict(pr["conv_sd"][name])
        conv.depth_shard = s
        xc = mine(pr["conv_x"][name])
        out[name] = _backward(conv, xc, mine(pr["conv_cot"][name]), conv.weight, conv.bias)
    for name, (size, align) in pr["resizes"].items():
        c = mine(pr["resize_cot"][name])
        out[name] = _backward(lambda v: spatial.resize_trilinear(v, size, align, s), x, c)

    t = mesh_of(MeshSpec(tensor=world)).tensor
    cols = lambda a: torch.from_numpy(np.split(a, world, -1)[t.rank].copy())
    lin = torch.nn.Linear(pr["lin_w"].shape[1] // world, pr["lin_w"].shape[0]).double()
    norm = torch.nn.LayerNorm(pr["ln_w"].shape[0] // world, eps=1e-5).double()
    with torch.no_grad():
        lin.weight.copy_(cols(pr["lin_w"]))
        lin.bias.copy_(torch.from_numpy(pr["lin_b"]))
        norm.weight.copy_(cols(pr["ln_w"]))
        norm.bias.copy_(cols(pr["ln_b"]))
    out["row_parallel_linear"] = _backward(
        lambda v: tensor_sharding.row_parallel_linear(v, lin, t), cols(pr["lin_x"]),
        torch.from_numpy(pr["lin_cot"]), lin.weight, lin.bias)
    out["layer_norm"] = _backward(lambda v: tensor_sharding.layer_norm(v, norm, t),
                                  cols(pr["ln_x"]), cols(pr["ln_cot"]), norm.weight, norm.bias)
    out["copy"] = _backward(lambda v: t.copy(v) * torch.from_numpy(pr["copy_w"][t.rank]),
                            torch.from_numpy(pr["copy_x"]), torch.ones(1, dtype=torch.float64))
    return out


def _losses_on_slabs(inp):
    """Each loss case on this rank's D slab of the test's logits, on a
    `spatial` line of every rank: its value and its logits' gradient."""
    from waveformer_tpu_torch.parallel import MeshSpec
    from waveformer_tpu_torch.parallel.mesh import make_mesh as mesh_of

    world = dist.get_world_size()
    s = mesh_of(MeshSpec(spatial=world)).spatial
    mine = lambda a: torch.from_numpy(np.split(a, world, 1)[s.rank].copy())
    out = {}
    for case, (name, kw, target) in inp["loss_cases"].items():
        logits = mine(inp["loss_logits"]).requires_grad_(True)
        loss = getattr(tl, name)(logits, mine(inp[target]), spatial=s, **kw)
        loss.backward()
        out[case] = (float(loss.detach()), logits.grad)
    return out


def _trainer_case(inp, spec, workdir):
    """`Trainer(mesh=...)` for 2 one-step epochs with full-volume
    validation, then the rank at (0, 0, 0) writes a periodic state, and a
    second trainer (other initial weights on every rank) resumes from it
    without training, then one that trains one more epoch."""
    from waveformer_tpu_torch.data.dataset import MedicalDataset
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.parallel import MeshSpec
    from waveformer_tpu_torch.parallel.mesh import make_mesh as mesh_of
    from waveformer_tpu_torch.training.trainer import Trainer

    mesh = mesh_of(MeshSpec(*spec))
    fullres = os.path.join(workdir, "fullres")
    names = sorted(f[:-4] for f in os.listdir(fullres) if f.endswith(".npz"))
    train_ds = MedicalDataset(fullres, names[:3], unpack=False)
    val_ds = MedicalDataset(fullres, names[3:], unpack=False)
    logdir = os.path.join(workdir, "trainer_" + "_".join(map(str, spec)))
    kw = dict(batch_size=1, val_every=1, num_steps_per_epoch=1, val_patches_per_epoch=1,
              patch_size=inp["trainer_cfg"]["img_size"], logdir=logdir, num_workers=0,
              augmentation="noaug", seed=3, mesh=mesh, full_val_every=1, full_val_cases=1)
    out = {"coords": mesh.coords}
    model = create_waveformer(inp["trainer_cfg"], device="cpu", seed=0)
    trainer = Trainer(model, max_epochs=2, resume=False, **kw)
    out["best"] = trainer.train(train_ds, val_ds)
    out["first"] = {k: v.detach().clone() for k, v in trainer.state.params.items()}
    out["module"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out["global_step"] = trainer.global_step
    out["wrote"] = trainer.writer is not None or trainer.ckpt is not None
    if mesh.is_main:
        trainer.ckpt.save_state(trainer.state, trainer.epoch)
    mesh.barrier()
    for tag, epochs in (("reloaded", 2), ("resumed", 3)):
        model = create_waveformer(inp["trainer_cfg"], device="cpu", seed=10 + dist.get_rank())
        again = Trainer(model, max_epochs=epochs, resume=True, **kw)
        again.train(train_ds, val_ds)
        out[tag] = {k: v.detach().clone() for k, v in again.state.params.items()}
        out[tag + "_step"] = again.global_step
    try:
        again.validation_single_gpu(val_ds)
        out["single_gpu_raised"] = False
    except RuntimeError:
        out["single_gpu_raised"] = True
    return out


def _ssl_case(inp, spec):
    """Two `SSLTrainer(mesh=...)` steps: the masters after."""
    from waveformer_tpu_torch.models.ssl import SSLViT
    from waveformer_tpu_torch.parallel import MeshSpec
    from waveformer_tpu_torch.parallel.mesh import make_mesh as mesh_of
    from waveformer_tpu_torch.training.ssl import SSLTrainer

    mesh = mesh_of(MeshSpec(*spec))
    model = SSLViT(**inp["ssl_cfg"])
    model.load_state_dict(inp["ssl_sd"], strict=True)
    trainer = SSLTrainer(model, num_steps=2, lr=1e-3, warmup_steps=1, eval_every=100,
                         logdir=os.path.join(inp["workdir"], "ssl_" + str(dist.get_rank())),
                         mesh=mesh, seed=5)
    trainer.train(iter(inp["ssl_batches"]))
    return {"params": {k: v.detach().clone() for k, v in trainer.state.params.items()},
            "losses": [float(v) for v in trainer.losses]}


def run_train_model_parallel(inp, mesh, workdir):
    inp = dict(inp, workdir=workdir)
    out, seconds = {"train": {}}, {}

    def timed(key, fn, *args):
        t0 = time.time()
        result = fn(*args)
        seconds[key] = time.time() - t0
        return result

    for spec in inp["specs"]:
        out["train"][spec] = timed(spec, _train_steps, inp, spec, inp["cfg"])
    out["primitives"] = timed("primitives", _primitive_grads, inp)
    out["losses"] = timed("losses", _losses_on_slabs, inp)
    for tag, (spec, cfg) in inp.get("extra_steps", {}).items():
        out[tag] = timed(tag, _train_steps, inp, spec, cfg)
    if "f64_spec" in inp:
        out["f64"] = timed("f64", _train_steps, inp, inp["f64_spec"], inp["cfg"], 1,
                           torch.float64)
    for spec in inp.get("trainer_specs", ()):
        out["trainer", spec] = timed(("trainer", spec), _trainer_case, inp, spec, workdir)
    for spec in inp.get("ssl_specs", ()):
        out["ssl", spec] = timed(("ssl", spec), _ssl_case, inp, spec)
    out["part_seconds"] = seconds
    return out


SUITES = {"parallel": run_parallel, "scripts": run_scripts,
          "model_parallel": run_model_parallel,
          "train_model_parallel": run_train_model_parallel}


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
