"""Runnable liver-CT example: flat-file dataset layout
(``volume-N.nii.gz`` / ``segmentation-N.nii.gz`` pairs, liver + tumor
labels), end to end on synthetic data, through the port's scripts.

The repository's `examples/liver_ct/run_example.py` on the port:

1. synthesizes a flat-file raw dataset (or uses ``--raw-dir``),
2. plans + preprocesses with ``CTPreprocessor`` (CT fingerprint
   normalization, anisotropic spacing),
3. trains a small Waveformer, 4. predicts, 5. computes liver/tumor Dice.

Run:  python -m waveformer_tpu_torch.examples.liver_ct --workdir /tmp/liver_demo
      [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np

from waveformer_tpu_torch.examples import arguments, run


def make_synthetic_dataset(raw_dir: str, n_cases: int, seed: int = 0) -> None:
    from waveformer_tpu_torch.utils import nifti

    os.makedirs(raw_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    affine = np.diag([1.0, 1.0, 2.5, 1.0]).astype(np.float32)  # anisotropic z
    for i in range(n_cases):
        shape = (48, 48, 24)
        vol = rng.normal(0.0, 60.0, shape).astype(np.float32)
        xs, ys, zs = np.ogrid[: shape[0], : shape[1], : shape[2]]
        cx, cy, cz = 24 + rng.integers(-3, 4), 22 + rng.integers(-3, 4), 12
        liver = (
            ((xs - cx) / 13) ** 2 + ((ys - cy) / 11) ** 2 + ((zs - cz) / 7) ** 2
        ) < 1.0
        tumor = (
            ((xs - cx - 4) / 4) ** 2 + ((ys - cy) / 4) ** 2 + ((zs - cz) / 3) ** 2
        ) < 1.0
        seg = np.zeros(shape, np.int8)
        seg[liver] = 1
        seg[tumor & liver] = 2
        vol[liver] += 90.0
        vol[tumor & liver] += 60.0
        nifti.save(nifti.NiftiImage(data=vol, affine=affine),
                   os.path.join(raw_dir, f"volume-{i}.nii.gz"))
        nifti.save(nifti.NiftiImage(data=seg, affine=affine),
                   os.path.join(raw_dir, f"segmentation-{i}.nii.gz"))
        # combined ground truth under the {case}/seg.nii.gz convention the
        # metrics CLI expects
        case_dir = os.path.join(raw_dir, str(i))
        os.makedirs(case_dir, exist_ok=True)
        nifti.save(nifti.NiftiImage(data=seg, affine=affine),
                   os.path.join(case_dir, "seg.nii.gz"))


def write_config(workdir: str, raw_dir: str, epochs: int, steps: int = 40) -> str:
    cfg = f"""\
data_dir: "{workdir}/fullres"
logdir: "{workdir}/logs/"
raw_data_dir: "{raw_dir}"
model_name: "waveformer_liver_demo"
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
  raw_spacing: [2.5, 1.0, 1.0]
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
    args = arguments(__doc__, "./liver_demo", "real flat-file liver dataset "
                     "(default: synthetic)").parse_args(argv)
    return run(args, make_synthetic_dataset,
               ["--dataset-type", "ct", "--foreground-classes", "1", "2"],
               write_config,
               ("preprocessing (flat-file CT driver)", "training",
                "computing metrics (liver=class1, tumor=class2)"))


if __name__ == "__main__":
    main()
