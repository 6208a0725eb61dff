"""Runnable BraTS2023 example: the flagship five-step pipeline at toy
scale, end to end on synthetic data, through the port's scripts.

The repository's `examples/brats2023/run_example.py` on the port: it

1. synthesizes a small BraTS-layout raw dataset (per-case directory with
   the four post-rename modality files + ``seg.nii.gz``; labels 1=NCR,
   2=ED, 3=ET), or uses ``--raw-dir`` if given,
2. plans + preprocesses it with the multi-modality MRI driver
   (per-channel z-score),
3. trains a small Waveformer with the BraTS TC/WT/ET region supervision,
4. runs sliding-window prediction on the validation split,
5. computes the (N, 3, 2) TC/WT/ET [Dice, HD95] array.

Run:  python -m waveformer_tpu_torch.examples.brats2023 --workdir /tmp/brats_demo
      [--device cpu]
For the real dataset, point --raw-dir at a renamed BraTS2023 tree
(``python -m waveformer_tpu_torch.scripts.rename_data``) and raise
epochs/steps back to the shipped ``examples/brats2023/config.yaml`` values.
"""

from __future__ import annotations

import os

import numpy as np

from waveformer_tpu_torch.examples import arguments, run

MODALITIES = ("t2w.nii.gz", "t2f.nii.gz", "t1n.nii.gz", "t1c.nii.gz")


def make_synthetic_dataset(raw_dir: str, n_cases: int, seed: int = 0) -> None:
    """BraTS post-rename layout: {case}/{t2w,t2f,t1n,t1c,seg}.nii.gz."""
    from waveformer_tpu_torch.utils import nifti

    rng = np.random.default_rng(seed)
    affine = np.diag([1.0, 1.0, 1.0, 1.0]).astype(np.float32)
    for i in range(n_cases):
        case = os.path.join(raw_dir, f"BraTS-GLI-{i:05d}-000")
        os.makedirs(case, exist_ok=True)
        shape = (48, 48, 40)  # (X, Y, Z)

        def blob(cx, cy, cz, r):
            xs, ys, zs = np.ogrid[: shape[0], : shape[1], : shape[2]]
            return (
                ((xs - cx) / r) ** 2
                + ((ys - cy) / r) ** 2
                + ((zs - cz) / r) ** 2
            ) < 1.0

        cx, cy, cz = (
            24 + rng.integers(-3, 4),
            24 + rng.integers(-3, 4),
            20 + rng.integers(-3, 4),
        )
        edema = blob(cx, cy, cz, 11)
        necrotic = blob(cx, cy, cz, 7)
        enhancing = blob(cx, cy, cz, 4)
        seg = np.zeros(shape, np.uint8)
        seg[edema] = 2
        seg[necrotic] = 1
        seg[enhancing] = 3
        brain = blob(24, 24, 20, 20)
        for m, fname in enumerate(MODALITIES):
            vol = np.zeros(shape, np.float32)
            vol[brain] = 600 + 150 * rng.standard_normal(int(brain.sum()))
            vol[edema] += 120 * (m + 1) / 4
            vol[enhancing] += 250 * (4 - m) / 4
            nifti.save(nifti.NiftiImage(data=vol, affine=affine),
                       os.path.join(case, fname))
        nifti.save(nifti.NiftiImage(data=seg, affine=affine),
                   os.path.join(case, "seg.nii.gz"))


def write_config(workdir: str, raw_dir: str, epochs: int, steps: int = 40) -> str:
    cfg = f"""\
data_dir: "{workdir}/fullres"
logdir: "{workdir}/logs/"
raw_data_dir: "{raw_dir}"
model_name: "waveformer_brats_demo"
data_list_path: "{workdir}/data_list"
split_path: "default_split"
max_epoch: {epochs}
batch_size: 2
val_every: {max(1, epochs // 2)}
num_steps_per_epoch: {steps}
val_patches_per_epoch: 8
roi_size: [32, 32, 32]
train_process: 2
seed: 123
lr: 0.0008
scheduler: "warmup_cosine"
warmup_epochs: 1
compute_dtype: "float32"
label_mode: "brats"

prediction:
  patch_size: [32, 32, 32]
  sw_batch_size: 4
  overlap: 0.25
  mirror_axes: [0, 1, 2]
  raw_spacing: [1.0, 1.0, 1.0]
  prediction_save: "{workdir}/predictions"

network:
  model_type: "Waveformer"
  in_channels: 4
  out_channels: 4
  img_size: [32, 32, 32]
  patch_size: 2
  transformer:
    embed_dims: [8, 16, 32, 64]
    depths: [1, 1, 1, 1]
    num_heads: [2, 4, 8, 8]
    decom_levels: [3, 2, 1, 0]
    multi_scale_attention: true
    drop_path_rate: 0.0

logging:
  log_file: "{workdir}/logs/example.log"
"""
    path = os.path.join(workdir, "config.yaml")
    with open(path, "w") as f:
        f.write(cfg)
    return path


def main(argv=None) -> np.ndarray:
    args = arguments(__doc__, "./brats_demo",
                     "real renamed BraTS2023 tree (default: synthetic)").parse_args(argv)
    return run(args, make_synthetic_dataset,
               ["--dataset-type", "mri", "--modalities", *MODALITIES],
               write_config,
               ("preprocessing (multi-modality MRI driver, z-score)",
                "training (TC/WT/ET region supervision)",
                "computing TC/WT/ET metrics"))


if __name__ == "__main__":
    main()
