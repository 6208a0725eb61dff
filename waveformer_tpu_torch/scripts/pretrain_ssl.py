"""SSL pretraining script (reference `self_supervised/train.py` capability):
contrastive + reconstruction pretraining of a 3D ViT on unlabeled volumes.

    python -m waveformer_tpu_torch.scripts.pretrain_ssl \
        (--data-dir D | --datalist-json J [--datalist-json J2 ...]) \
        [--device cuda|cpu] [...]

The JAX package's `scripts/pretrain_ssl.py` on one CUDA device (or the CPU
when asked): `--device` takes the place of `--platform`, and there is no
XLA compilation cache. The `SSLViT` is built in fp32 from `--seed` and
trains in bf16 on fp32 masters, as the JAX script's bf16 module on fp32
params does.
"""

from __future__ import annotations

import argparse

import torch

from waveformer_tpu_torch.device import resolve_device


def main(argv=None):
    """Run the script; returns the `SSLTrainer` it ran (best validation L1
    in `best_val`)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", default=None,
                    help="preprocessed npz/pkl dataset dir")
    ap.add_argument(
        "--datalist-json", action="append", default=[],
        help="decathlon dataset JSON(s) of raw whole volumes (the reference "
             "SSL CT flow, self_supervised/data_utils.py:30-139); "
             "repeatable, combined into one training list",
    )
    ap.add_argument(
        "--datalist-base-dir", action="append", default=[],
        help="base dir per --datalist-json (defaults to the JSON's dir)",
    )
    ap.add_argument("--a-min", type=float, default=-1000.0)
    ap.add_argument("--a-max", type=float, default=1000.0)
    ap.add_argument("--b-min", type=float, default=0.0)
    ap.add_argument("--b-max", type=float, default=1.0)
    ap.add_argument("--cache-rate", type=float, default=0.0,
                    help="CacheDataset-style eager cache fraction")
    ap.add_argument("--smartcache-num", type=int, default=0,
                    help="SmartCacheDataset-style rotating cache size")
    ap.add_argument("--sw-batch-size", type=int, default=2,
                    help="random crops per loaded volume (datalist mode)")
    ap.add_argument("--logdir", default="./logs_ssl")
    ap.add_argument("--num-steps", type=int, default=10000)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--patch-size", type=int, nargs=3, default=[96, 96, 96])
    ap.add_argument("--vit-patch", type=int, default=16)
    ap.add_argument("--in-channels", type=int, default=4)
    ap.add_argument("--hidden-size", type=int, default=768)
    ap.add_argument("--num-layers", type=int, default=12)
    ap.add_argument("--num-heads", type=int, default=12)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--warmup-steps", type=int, default=500)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--num-workers", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                    "on the CPU)")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from waveformer_tpu_torch.models.ssl import create_ssl_vit
    from waveformer_tpu_torch.training.ssl import SSLTrainer
    from waveformer_tpu_torch.utils.logger import setup_logging

    setup_logging(log_file=f"{args.logdir}/pretrain.log")
    if bool(args.data_dir) == bool(args.datalist_json):
        ap.error("give exactly one of --data-dir or --datalist-json")

    loader = None
    if args.datalist_json:
        # reference SSL CT flow: decathlon datalists of raw whole volumes,
        # cached dataset, random ROI crops (`data_utils.py:30-139`)
        from waveformer_tpu_torch.data.ssl_data import (
            SSLCropLoader,
            SSLVolumeDataset,
            load_decathlon_datalist,
        )

        train_list, val_list = [], []
        for i, js in enumerate(args.datalist_json):
            base = (
                args.datalist_base_dir[i]
                if i < len(args.datalist_base_dir)
                else None
            )
            train_list += load_decathlon_datalist(
                js, False, "training", base_dir=base
            )
            try:
                val_list += load_decathlon_datalist(
                    js, False, "validation", base_dir=base
                )
            except ValueError:
                pass
        if not val_list:
            n_val = max(1, len(train_list) // 10)
            val_list, train_list = train_list[:n_val], train_list[n_val:]
        common = dict(
            roi=tuple(args.patch_size), a_min=args.a_min, a_max=args.a_max,
            b_min=args.b_min, b_max=args.b_max,
        )
        train_ds = SSLVolumeDataset(
            train_list, cache_rate=args.cache_rate,
            smart_cache_num=args.smartcache_num, **common,
        )
        val_ds = SSLVolumeDataset(val_list, **common)
        args.in_channels = 1

        def batches():
            yield from SSLCropLoader(
                train_ds, batch_size=args.batch_size,
                num_samples=args.sw_batch_size,
                num_steps=args.num_steps + 1, seed=args.seed,
            )

        val_batches = list(
            SSLCropLoader(
                val_ds, batch_size=args.batch_size,
                num_samples=args.sw_batch_size, num_steps=4,
                seed=args.seed + 1, prefetch=False,
            )
        )
    else:
        from waveformer_tpu_torch.data.dataset import MedicalDataset, _all_cases
        from waveformer_tpu_torch.data.pipeline import PrefetchLoader

        cases = _all_cases(args.data_dir)
        n_val = max(1, len(cases) // 10)
        train_ds = MedicalDataset(args.data_dir, cases[n_val:])
        val_ds = MedicalDataset(args.data_dir, cases[:n_val], unpack=False)

        loader = PrefetchLoader(
            train_ds,
            steps_per_epoch=args.num_steps + 1,
            patch_size=tuple(args.patch_size),
            batch_size=args.batch_size,
            transform="noaug",
            num_workers=args.num_workers,
            seed=args.seed,
        )

        def batches():
            for b in loader:
                yield b["data"]

        val_loader = PrefetchLoader(
            val_ds, steps_per_epoch=4, patch_size=tuple(args.patch_size),
            batch_size=args.batch_size, transform="val", num_workers=0,
            seed=args.seed + 1,
        )
        val_batches = [b["data"] for b in val_loader]

    model = create_ssl_vit(
        device=device,
        seed=args.seed,
        img_size=tuple(args.patch_size),
        patch_size=args.vit_patch,
        in_channels=args.in_channels,
        hidden_size=args.hidden_size,
        mlp_dim=4 * args.hidden_size,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
    )
    trainer = SSLTrainer(
        model,
        num_steps=args.num_steps,
        lr=args.lr,
        warmup_steps=args.warmup_steps,
        eval_every=args.eval_every,
        logdir=args.logdir,
        seed=args.seed,
        compute_dtype=torch.bfloat16,
    )
    try:
        best = trainer.train(batches(), val_batches)
    finally:
        if loader is not None:
            loader.shutdown()
    print(f"pretraining done; best val recon L1 {best:.4f}")
    return trainer


if __name__ == "__main__":
    main()
