"""Runnable abdominal-CT example: the full five-step pipeline on an
AbdomenAtlas-style dataset (per-case ``ct.nii.gz`` + per-organ binary
masks), end to end on synthetic data, through the port's scripts.

The repository's `examples/abdomen_ct/run_example.py` on the port: it

1. synthesizes a small raw dataset (or uses ``--raw-dir`` if given),
2. plans + preprocesses it with ``OrganMaskPreprocessor`` (CT
   normalization from the dataset fingerprint),
3. trains a small Waveformer for a few epochs,
4. runs sliding-window prediction on the validation split,
5. computes per-organ Dice/HD95.

Run:  python -m waveformer_tpu_torch.examples.abdomen_ct --workdir /tmp/abdomen_demo
      [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np

from waveformer_tpu_torch.examples import arguments, run

ORGANS = ("liver.nii.gz", "spleen.nii.gz")


def make_synthetic_dataset(raw_dir: str, n_cases: int, seed: int = 0) -> None:
    """AbdomenAtlas layout: {case}/ct.nii.gz + {case}/segmentations/{organ}.
    Also writes a combined {case}/seg.nii.gz for evaluation."""
    from waveformer_tpu_torch.utils import nifti

    rng = np.random.default_rng(seed)
    affine = np.diag([1.5, 1.5, 3.0, 1.0]).astype(np.float32)
    for i in range(n_cases):
        case = os.path.join(raw_dir, f"BDMAP_{i:08d}")
        seg_dir = os.path.join(case, "segmentations")
        os.makedirs(seg_dir, exist_ok=True)
        shape = (48, 48, 32)  # (X, Y, Z)
        vol = rng.normal(0.0, 40.0, shape).astype(np.float32)

        def blob(cx, cy, cz, r):
            xs, ys, zs = np.ogrid[: shape[0], : shape[1], : shape[2]]
            return (
                ((xs - cx) / r) ** 2
                + ((ys - cy) / r) ** 2
                + ((zs - cz) / (r * 0.7)) ** 2
            ) < 1.0

        liver = blob(
            18 + rng.integers(-2, 3), 20 + rng.integers(-2, 3),
            14 + rng.integers(-2, 3), 10,
        )
        spleen = blob(
            34 + rng.integers(-2, 3), 30 + rng.integers(-2, 3),
            18 + rng.integers(-2, 3), 6,
        )
        vol[liver] += 120.0
        vol[spleen] += 220.0
        combined = np.zeros(shape, np.uint8)
        combined[liver] = 1
        combined[spleen] = 2
        nifti.save(nifti.NiftiImage(data=vol, affine=affine),
                   os.path.join(case, "ct.nii.gz"))
        for organ, mask in (("liver.nii.gz", liver), ("spleen.nii.gz", spleen)):
            nifti.save(
                nifti.NiftiImage(data=mask.astype(np.uint8), affine=affine),
                os.path.join(seg_dir, organ),
            )
        nifti.save(nifti.NiftiImage(data=combined, affine=affine),
                   os.path.join(case, "seg.nii.gz"))


def write_config(workdir: str, raw_dir: str, epochs: int, steps: int = 40) -> str:
    cfg = f"""\
data_dir: "{workdir}/fullres"
logdir: "{workdir}/logs/"
raw_data_dir: "{raw_dir}"
model_name: "waveformer_abdomen_demo"
data_list_path: "{workdir}/data_list"
split_path: "default_split"
max_epoch: {epochs}
batch_size: 2
val_every: {max(1, epochs // 2)}
num_steps_per_epoch: {steps}
val_patches_per_epoch: 8
roi_size: [32, 32, 32]
train_process: 2
seed: 42
lr: 0.0008
scheduler: "warmup_cosine"
warmup_epochs: 1
compute_dtype: "float32"
label_mode: "multiclass"

prediction:
  patch_size: [32, 32, 32]
  sw_batch_size: 4
  overlap: 0.25
  mirror_axes: [0, 1, 2]
  raw_spacing: [1.0, 1.0, 1.0]
  prediction_save: "{workdir}/predictions"

network:
  model_type: "Waveformer"
  in_channels: 1
  out_channels: 3
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
    args = arguments(__doc__, "./abdomen_demo",
                     "real AbdomenAtlas-style dataset (default: synthetic)").parse_args(argv)
    return run(args, make_synthetic_dataset,
               ["--dataset-type", "ct-organs", "--organ-list", *ORGANS],
               write_config,
               ("preprocessing (ct-organs driver, CT normalization)", "training",
                "computing metrics"))


if __name__ == "__main__":
    main()
