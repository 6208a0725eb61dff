"""Step 4 — full-volume test-set inference (reference `4_predict.py`).

    python -m waveformer_tpu_torch.scripts.predict --config config.yaml \
        [--checkpoint best_model.npz] [--split test|val] [--tta 1|2|4|8]
        [--no-tta] [--device cuda|cpu] [--sharded auto|on|off]
    torchrun --nproc-per-node N -m waveformer_tpu_torch.scripts.predict \
        --config config.yaml --sharded on

Builds the config's model (`models.create_model`: WaveFormer or Swin
UNETR by `network.model_type`), loads the best params checkpoint (the JAX
package's `.npz` format; a Swin UNETR's by its state dict keys), runs
mirror-TTA sliding-window inference per case on the CUDA device (or the
CPU when asked), restores the original geometry and writes
`{case}.nii.gz` predictions, as `waveformer_tpu/scripts/predict.py` does.
`--sharded on` (or `auto` with more than one process) shares the cases out
over the processes of the group `torchrun` describes, one per card
(`Predictor.predict_cases_sharded`), joining it unless the caller has;
each process writes only its own cases' files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from waveformer_tpu_torch.config import load_config
from waveformer_tpu_torch.data.dataset import get_train_val_test_loader_from_train
from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.inference import Predictor, SlidingWindowInferer
from waveformer_tpu_torch.models import create_model
from waveformer_tpu_torch.parallel.mesh import (
    init_distributed, main_rank_first, make_mesh, world_size)
from waveformer_tpu_torch.training.checkpoint import (
    CheckpointManager, checkpoint_state_dict, load_params_npz)
from waveformer_tpu_torch.utils.determinism import set_determinism
from waveformer_tpu_torch.utils.logger import get_logger, setup_logging_from_config


def main(argv=None):
    """Run the script; returns {"cases", "seconds", "cases_per_s"} of the
    cases this process predicted and wrote."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--checkpoint", default=None,
                    help="params .npz (default: best_model in logdir/model)")
    ap.add_argument("--split", choices=("test", "val"), default="test")
    ap.add_argument(
        "--tta", type=int, choices=(1, 2, 4, 8), default=None,
        help="mirror-TTA orientations per case (overrides the config); "
        "8 = the reference protocol, 1 = no TTA",
    )
    ap.add_argument("--no-tta", action="store_true", help="alias for --tta 1")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' runs "
                    "the kernels' plain versions)")
    ap.add_argument(
        "--sharded", choices=("auto", "on", "off"), default="auto",
        help="share whole cases out over the processes of the group, one "
        "per card (Predictor.predict_cases_sharded); 'auto' shards when "
        "there is more than one process",
    )
    args = ap.parse_args(argv)
    mesh = None
    if args.sharded == "on" or (args.sharded == "auto" and world_size() > 1):
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
            init_distributed(args.device)
        mesh = make_mesh()
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    if mesh is None or mesh.is_main:
        setup_logging_from_config(cfg.logging)
    log = get_logger()
    set_determinism(cfg.seed)

    with main_rank_first(mesh):
        _, val_ds, test_ds = get_train_val_test_loader_from_train(
            cfg.data_dir,
            test_list_path=os.path.join(cfg.data_list_path, "test_list.pkl"),
            split_dir=os.path.join(cfg.data_list_path, cfg.split_path),
        )
    ds = test_ds if args.split == "test" else val_ds
    log.info(f"predicting {len(ds)} {args.split} cases")

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    # channels-first end to end: preprocessed volumes are stored (C, D, H, W)
    model = create_model(cfg.network, dtype=dtype, device=device, io_layout="channels_first")

    ckpt_path = args.checkpoint
    if ckpt_path is None:
        ckpt_path = CheckpointManager(os.path.join(cfg.logdir, "model")).find_best()
    if ckpt_path is None:
        ap.error("no checkpoint found; pass --checkpoint")
    log.info(f"loading {ckpt_path}")
    model.load_state_dict(checkpoint_state_dict(model, load_params_npz(ckpt_path)), strict=True)

    pred_cfg = cfg.prediction
    if args.no_tta:
        args.tta = 1
    if args.tta is not None:
        pred_cfg = dataclasses.replace(pred_cfg, tta_orientations=args.tta)
    mirror_axes = pred_cfg.effective_mirror_axes()
    log.info(
        f"TTA protocol: {2 ** len(mirror_axes or ())} orientation(s) "
        f"(mirror_axes={mirror_axes})"
    )
    inferer = SlidingWindowInferer(
        roi_size=cfg.prediction.patch_size,
        sw_batch_size=cfg.prediction.sw_batch_size,
        overlap=cfg.prediction.overlap,
        mirror_axes=mirror_axes,
        layout="channels_first",
        tta_mode="patch",
    )
    predictor = Predictor(inferer, upload_dtype=dtype, device=device)
    out_dir = cfg.prediction.prediction_save
    os.makedirs(out_dir, exist_ok=True)

    t_start = time.time()
    items = [ds[i] for i in range(len(ds))]
    # preprocessed volumes are already (C, D, H, W): feed them straight in
    if mesh is not None:
        log.info(f"case-sharded inference: rank {mesh.rank} of {mesh.size}")
        pairs = ((items[i], seg) for i, seg in predictor.predict_cases_sharded(
            [it["data"] for it in items], model,
            out_channels=cfg.network.out_channels,
            properties_list=[it["properties"] for it in items], mesh=mesh))
    else:
        segs = predictor.predict_cases(
            (np.asarray(it["data"]) for it in items),
            model,
            out_channels=cfg.network.out_channels,
            properties_list=[it["properties"] for it in items],
        )
        pairs = zip(items, segs)
    n_done = 0
    t0 = time.time()
    for item, seg in pairs:
        n_done += 1
        predictor.save_to_nii(
            seg,
            os.path.join(out_dir, item["name"] + ".nii.gz"),
            spacing=cfg.prediction.raw_spacing,
            properties=item["properties"],
        )
        log.info(f"{item['name']}: {time.time() - t0:.1f}s")
        t0 = time.time()
    dt = time.time() - t_start
    n = max(n_done, 1)
    log.info(f"done: {n_done} cases in {dt:.1f}s ({n / dt:.3f} cases/s)")
    return {"cases": n_done, "seconds": dt, "cases_per_s": n / dt}


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
