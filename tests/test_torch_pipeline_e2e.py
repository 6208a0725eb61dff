"""The five-step pipeline through the port: `tests/test_pipeline_e2e.py`'s
chain and fixture (5 synthetic BraTS2023-named cases, the small network at
roi 32³, 30 steps an epoch, 2 loader workers) through the `main`s of the
port's scripts with `--device cpu`:

    rename_data → preprocess → train → predict → compute_metrics

It asserts the artifacts of every step, a finite (1, 3, 2) metrics array
and that the model learned the (easy) synthetic target: WT Dice > 0.5.
The run trains 3 epochs where the JAX test trains 2: the two workers queue
their batches in no fixed order, and after 2 epochs the WT Dice of four
runs spread over 0.47-0.59 (the JAX test's own comment gives 0.4-0.6 and
asserts > 0.3); after 3 epochs seven runs gave 0.636-0.718.
"""

import os

import numpy as np
import pytest
import torch

MODALITIES = ("t2w", "t2f", "t1n", "t1c")
WT_DICE_MIN = 0.5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the tier-1 run puts six pytest workers on
    the cores, and torch's thread pools then contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def brats_raw(tmp_path_factory):
    """5 synthetic BraTS2023-named cases with a strong, learnable target:
    label 1 (NCR) blob and an inner label 3 (ET) core, both with big
    intensity offsets in every modality (`test_pipeline_e2e.py`'s fixture,
    written with the port's NIfTI writer)."""
    from waveformer_tpu_torch.utils import nifti

    root = tmp_path_factory.mktemp("brats_raw")
    rng = np.random.default_rng(7)
    affine = np.eye(4, dtype=np.float32)
    for i in range(5):
        name = f"BraTS-GLI-{i:05d}-000"
        case = root / name
        os.makedirs(case)
        shape = (44, 44, 36)
        cx, cy, cz = (
            20 + rng.integers(-3, 4),
            20 + rng.integers(-3, 4),
            17 + rng.integers(-3, 4),
        )
        xs, ys, zs = np.ogrid[: shape[0], : shape[1], : shape[2]]
        r2 = (xs - cx) ** 2 + (ys - cy) ** 2 + (zs - cz) ** 2
        tumor = r2 < 9**2
        core = r2 < 4**2
        seg = np.zeros(shape, np.int8)
        seg[tumor] = 1
        seg[core] = 3
        for mod in MODALITIES:
            vol = rng.standard_normal(shape).astype(np.float32)
            vol[tumor] += 4.0
            vol[core] += 4.0
            nifti.save(nifti.NiftiImage(data=vol, affine=affine),
                       str(case / f"{name}-{mod}.nii.gz"))
        nifti.save(nifti.NiftiImage(data=seg, affine=affine),
                   str(case / f"{name}-seg.nii.gz"))
    return str(root)


def config_text(work, fullres, raw):
    return f"""\
data_dir: "{fullres}"
logdir: "{work}/logs/"
raw_data_dir: "{raw}"
model_name: "e2e_test"
data_list_path: "{work}/data_list"
split_path: "default_split"
max_epoch: 3
batch_size: 2
val_every: 1
num_steps_per_epoch: 30
val_patches_per_epoch: 4
roi_size: [32, 32, 32]
train_process: 2
seed: 42
lr: 0.002
scheduler: "warmup_cosine"
warmup_epochs: 0.5
compute_dtype: "float32"
label_mode: "brats"
prediction:
  patch_size: [32, 32, 32]
  sw_batch_size: 4
  overlap: 0.25
  mirror_axes: [0, 1, 2]
  raw_spacing: [1.0, 1.0, 1.0]
  prediction_save: "{work}/predictions"
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
  log_file: "{work}/logs/e2e.log"
"""


def test_five_step_pipeline(brats_raw, tmp_path):
    from waveformer_tpu_torch.scripts import compute_metrics, predict, preprocess, rename_data, train

    work = tmp_path

    # step 1: rename
    rename_data.main([brats_raw])
    case0 = os.path.join(brats_raw, sorted(os.listdir(brats_raw))[0])
    assert "seg.nii.gz" in os.listdir(case0)

    # step 2: preprocess
    fullres = str(work / "fullres")
    preprocess.main([
        "--raw-dir", brats_raw, "--out-dir", fullres,
        "--modalities", *[m + ".nii.gz" for m in MODALITIES],
        "--num-processes", "1",
    ])
    assert os.path.exists(os.path.join(fullres, "plans.json"))
    assert len([f for f in os.listdir(fullres) if f.endswith(".npz")]) == 5

    config_path = str(work / "config.yaml")
    with open(config_path, "w") as f:
        f.write(config_text(work, fullres, brats_raw))

    # step 3: train
    trainer = train.main(["--config", config_path, "--device", "cpu"])
    assert [n for n, _, _ in trainer.epoch_times] == [30, 30, 30]
    model_dir = os.path.join(str(work), "logs", "model")
    assert any(f.startswith("best_model") for f in os.listdir(model_dir))

    # step 4: predict (validation split; no test list)
    predict.main(["--config", config_path, "--split", "val", "--no-tta", "--device", "cpu"])
    preds = os.listdir(str(work / "predictions"))
    assert len(preds) == 1 and preds[0].endswith(".nii.gz")

    # step 5: metrics
    out_npy = str(work / "result_metrics.npy")
    compute_metrics.main(["--config", config_path, "--split", "val", "--out", out_npy,
                          "--device", "cpu"])
    results = np.load(out_npy)
    assert results.shape == (1, 3, 2)  # (cases, TC/WT/ET, dice+hd95)
    assert np.isfinite(results).all()
    wt_dice = results[0, 1, 0]
    assert wt_dice > WT_DICE_MIN, f"model failed to learn the synthetic target: {wt_dice}"
