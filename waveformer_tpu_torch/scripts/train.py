"""Step 3 — train WaveFormer on preprocessed data (reference `3_train.py`).

    python -m waveformer_tpu_torch.scripts.train --config config.yaml \
        [--no-resume] [--plans auto|plans.json] [--device cuda|cpu]
    torchrun --nproc-per-node N -m waveformer_tpu_torch.scripts.train \
        --multihost --config config.yaml

The JAX package's `scripts/train.py` on one CUDA device (or the CPU when
asked): config, logging, determinism, the persisted train/val split, the
network in fp32 from `models.create_model(cfg.network)` (WaveFormer or Swin
UNETR by `network.model_type`), then
`Trainer.train`, which takes its fp32 masters and then casts the network to
the config's compute dtype. `--device` takes the place of `--platform`.
`--multihost` (the JAX script calls `jax.distributed.initialize()` there)
joins the process group `torchrun` describes (`parallel.init_distributed`:
NCCL on the cards, gloo with `--device cpu`) unless the caller has joined
one, and trains with `Trainer(mesh=make_mesh())`: one process per card,
the config's `batch_size` the global batch. Rank 0 writes the persisted
split and the unpacked cases first, and alone the log file, TensorBoard
scalars and checkpoints.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch
import torch.distributed as dist

from waveformer_tpu_torch.config import Config, load_config
from waveformer_tpu_torch.data.dataset import get_train_val_test_loader_from_train
from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.models import create_model
from waveformer_tpu_torch.parallel.mesh import Mesh, init_distributed, main_rank_first, make_mesh
from waveformer_tpu_torch.training.trainer import Trainer
from waveformer_tpu_torch.utils.determinism import set_determinism
from waveformer_tpu_torch.utils.logger import get_logger, setup_logging_from_config


def build_model(cfg: Config, device: Optional[torch.device] = None) -> torch.nn.Module:
    """The config's network in fp32 on `device`, channels-last as the
    trainer's batches are; the weights come from torch's generator, which
    `set_determinism(cfg.seed)` seeds. The trainer casts it to the config's
    compute dtype once these fp32 weights are its masters."""
    return create_model(cfg.network, device=device)


def build_trainer(cfg: Config, model: torch.nn.Module, resume: bool = True,
                  mesh: Optional[Mesh] = None) -> Trainer:
    """`Trainer` with the config's settings, as the JAX script makes it."""
    return Trainer(
        model,
        max_epochs=cfg.max_epoch,
        batch_size=cfg.batch_size,
        val_every=cfg.val_every,
        num_steps_per_epoch=cfg.num_steps_per_epoch,
        val_patches_per_epoch=cfg.val_patches_per_epoch,
        patch_size=cfg.roi_size,
        lr=cfg.lr,
        weight_decay=cfg.weight_decay,
        grad_clip_norm=cfg.grad_clip_norm,
        scheduler=cfg.scheduler,
        warmup_epochs=cfg.warmup_epochs,
        logdir=cfg.logdir,
        model_name=cfg.model_name,
        mesh=mesh,
        num_workers=cfg.train_process,
        full_val_every=cfg.full_val_every,
        full_val_cases=cfg.full_val_cases,
        label_mode=cfg.extra.get("label_mode", "brats"),
        num_classes=cfg.network.out_channels,
        seed=cfg.seed,
        resume=resume,
        compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32,
    )


def main(argv=None) -> Trainer:
    """Run the script; returns the trainer it ran (best dice in
    `best_mean_dice`)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--multihost", action="store_true",
                    help="one process per card in the process group torchrun "
                    "describes (data parallelism over the cards)")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                    "the kernels' plain versions)")
    ap.add_argument(
        "--plans", default=None,
        help="plans.json written by preprocessing; its patch size "
        "configures roi_size/img_size (the reference's plans-handler "
        "round-trip). Pass 'auto' to pick up <data_dir>/plans.json when "
        "present; default: config values only",
    )
    args = ap.parse_args(argv)
    mesh = None
    if args.multihost:
        if not dist.is_initialized():
            init_distributed(args.device)
        mesh = make_mesh()
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    if mesh is None or mesh.is_main:
        setup_logging_from_config(cfg.logging)
    log = get_logger()
    set_determinism(cfg.seed)

    if args.plans:
        from waveformer_tpu_torch.data.planning import Plans

        plans = Plans.find(cfg.data_dir) if args.plans == "auto" else Plans.load(args.plans)
        if plans is not None and "patch_size" in plans.raw:
            cfg = plans.apply_to_config(cfg)
            log.info(f"plans: patch {plans.patch_size} -> network "
                     f"{cfg.network.img_size}, spacing {plans.target_spacing}")
        elif args.plans != "auto":
            ap.error(f"--plans {args.plans}: no usable patch_size")

    with main_rank_first(mesh):
        train_ds, val_ds, _ = get_train_val_test_loader_from_train(
            cfg.data_dir,
            test_list_path=os.path.join(cfg.data_list_path, "test_list.pkl"),
            split_dir=os.path.join(cfg.data_list_path, cfg.split_path),
        )
    log.info(f"train {len(train_ds)} / val {len(val_ds)} cases")

    trainer = build_trainer(cfg, build_model(cfg, device), resume=not args.no_resume,
                            mesh=mesh)
    best = trainer.train(train_ds, val_ds)
    log.info(f"training done; best mean dice {best:.4f}")
    return trainer


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
