"""The port's deploy wrapper (`waveformer_tpu_torch/deploy/process.py`)
against the JAX package's, on the CPU.

Setup: the tiny network of `tests/test_deploy_examples.py` (2 modalities,
3 classes, dims 4/8/16/32, roi 16³, 8-way mirror TTA from the config) in
fp32, JAX parameters from `model.init` saved with the JAX package's
`save_params_npz`, and one raw 2-modality (20, 24, 18) case under an LPS
affine at 1.2 × 1.0 × 1.1 mm, nonzero in an ellipsoid (so the wrapper crops
and resamples). Both `deploy.process.main` run with and without TTA
(`--device cpu` on the port's side).

Agreement rule (that of `tests/test_torch_scripts.py`): the geometry is
exact (the raw shape, affines within 1e-6); the label maps agree on at
least 99.9% of the voxels, and a voxel may differ only where the port's
two top logits are within 2e-4 (fp32 sums in other orders). The port's
file also equals its own `read_data` → `run_case_npy` → `predict_case` →
`save_to_nii` voxel for voxel.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.config import load_config as jax_load_config
from waveformer_tpu.deploy import process as jax_process
from waveformer_tpu.models import create_waveformer as jax_create_waveformer
from waveformer_tpu.training.checkpoint import save_params_npz as jax_save_params_npz
from waveformer_tpu.utils import nifti as jax_nifti
from waveformer_tpu_torch.config import Config
from waveformer_tpu_torch.deploy import process
from waveformer_tpu_torch.tools import synthetic_cases
from waveformer_tpu_torch.utils import nifti

TINY_NETWORK_YAML = """\
compute_dtype: "float32"

prediction:
  patch_size: [16, 16, 16]
  sw_batch_size: 2
  overlap: 0.25
  mirror_axes: [0, 1, 2]

network:
  in_channels: 2
  out_channels: 3
  img_size: [16, 16, 16]
  patch_size: 2
  transformer:
    embed_dims: [4, 8, 16, 32]
    depths: [1, 1, 1, 1]
    num_heads: [1, 2, 4, 4]
    decom_levels: [3, 2, 1, 0]
    drop_path_rate: 0.0
"""
RAW_SHAPE = (20, 24, 18)
SOURCE_AFFINE = np.diag([-1.2, -1.0, 1.1, 1.0]).astype(np.float32)
SOURCE_AFFINE[:3, 3] = (22.8, 23.0, -9.0)
MODALITIES = ("a.nii.gz", "b.nii.gz")
LABEL_AGREEMENT = 0.999
TIE_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for the module: the tier-1 run puts six
    pytest workers on the cores, and torch's thread pools then contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """Both wrappers run on one raw case, with and without TTA."""
    root = tmp_path_factory.mktemp("deploy")
    config = str(root / "config.yaml")
    with open(config, "w") as f:
        f.write(TINY_NETWORK_YAML)
    cfg = jax_load_config(config)
    model = jax_create_waveformer(cfg.network.model_kwargs(), dtype=jnp.float32,
                                  io_layout="channels_first")
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, 16, 16, 16)))
    ckpt = str(root / "model.npz")
    jax_save_params_npz(jax.device_get(params), ckpt)

    rng = np.random.default_rng(0)
    case = root / "input" / "case_A"
    os.makedirs(case)
    grid = np.ogrid[tuple(slice(0, n) for n in RAW_SHAPE)]
    brain = sum(((g - (n - 1) / 2) / ((n - 1) / 2 - 1.5)) ** 2
                for g, n in zip(grid, RAW_SHAPE)) < 1.0
    for mod in MODALITIES:
        vol = np.where(brain, rng.normal(1.0, 1.0, RAW_SHAPE), 0.0).astype(np.float32)
        nifti.save(nifti.NiftiImage(data=vol, affine=SOURCE_AFFINE), str(case / mod))

    runs = {"root": root, "config": config, "checkpoint": ckpt}
    for tta in (False, True):
        common = ["--checkpoint", ckpt, "--config", config, "--input-dir", str(root / "input"),
                  "--modalities", *MODALITIES] + ([] if tta else ["--no-tta"])
        jax_process.main(common + ["--output-dir", str(root / f"jax_{tta}")])
        runs[("port", tta)] = process.main(
            common + ["--output-dir", str(root / f"port_{tta}"), "--device", "cpu"])
    return runs


def _case(algo):
    data, _, props = algo.preprocessor.read_data("case_A")
    return algo.preprocessor.run_case_npy(data, None, props)


@pytest.mark.parametrize("tta", [False, True])
def test_deploy_matches_jax(deployed, tta):
    root = deployed["root"]
    want = jax_nifti.load(str(root / f"jax_{tta}" / "case_A.nii.gz"))
    got = nifti.load(str(root / f"port_{tta}" / "case_A.nii.gz"))
    assert got.data.shape == want.data.shape == RAW_SHAPE
    assert got.data.dtype == want.data.dtype == np.uint8
    np.testing.assert_allclose(got.affine, want.affine, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.affine, SOURCE_AFFINE, rtol=0, atol=1e-6)
    assert set(np.unique(got.data)) <= {0, 1, 2}
    differ = got.data != want.data
    assert 1.0 - differ.mean() >= LABEL_AGREEMENT, differ.sum()
    if differ.any():  # flips only at near-ties of the port's two top logits
        algo = deployed[("port", tta)]
        vol, _, props = _case(algo)
        pred = algo.predictor
        with torch.inference_mode():
            logits = pred.resample_logits_to_crop(
                pred.predict_logits(torch.from_numpy(vol), algo.model, 3), props)
        flip_dhw = nifti.apply_orientation(differ, np.asarray(props["orientation"])).T
        crop = flip_dhw[tuple(slice(b0, b1) for b0, b1 in props["bbox_used_for_cropping"])]
        assert crop.sum() == differ.sum(), "a label differs outside the crop"
        top2 = np.sort(logits[:, crop], axis=0)[-2:]
        assert float((top2[1] - top2[0]).max()) <= TIE_TOL


@pytest.mark.parametrize("tta", [False, True])
def test_deploy_equals_its_own_pipeline(deployed, tta):
    """The wrapper's file is `read_data` → `run_case_npy` → `predict_case` →
    `save_to_nii` of the same model, voxel for voxel; the crop and the
    resampling were real."""
    algo = deployed[("port", tta)]
    assert algo.cfg.network.in_channels == 2 and algo.device == torch.device("cpu")
    assert algo.predictor.inferer.mirror_axes == ((0, 1, 2) if tta else None)
    vol, _, props = _case(algo)
    assert props["shape_after_resample"] != props["shape_after_cropping_before_resample"]
    assert props["shape_after_cropping_before_resample"] != props["shape_before_cropping"]
    seg = algo.predictor.predict_case(vol, algo.model, 3, props)
    out = str(deployed["root"] / f"in_process_{tta}.nii.gz")
    algo.predictor.save_to_nii(seg, out, properties=props)
    got = nifti.load(str(deployed["root"] / f"port_{tta}" / "case_A.nii.gz"))
    np.testing.assert_array_equal(got.data, nifti.load(out).data)
    np.testing.assert_array_equal(got.affine, nifti.load(out).affine)
    (times,) = algo.case_times
    assert times["case"] == "case_A"
    assert all(times[k] >= 0 for k in ("read_s", "preprocess_s", "predict_s", "write_s"))


def test_deploy_without_config_uses_defaults(deployed, tmp_path):
    """A config path that does not exist means `Config()` (the flagship),
    as in the JAX wrapper."""
    ckpt = str(tmp_path / "flagship.npz")
    synthetic_cases.write_checkpoint(ckpt, Config().network.model_kwargs(), seed=0)
    algo = process.InferenceAlgorithm(ckpt, config_path=str(tmp_path / "missing.yaml"),
                                      input_dir=str(deployed["root"] / "input"),
                                      output_dir=str(tmp_path / "out"), device="cpu")
    assert algo.cfg == Config()
    assert algo.modalities == ("t2w.nii.gz", "t2f.nii.gz", "t1n.nii.gz", "t1c.nii.gz")
    assert next(algo.model.parameters()).dtype == torch.bfloat16


def test_deploy_refuses_silent_cpu(deployed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--checkpoint", deployed["checkpoint"], "--config", deployed["config"],
            "--input-dir", str(deployed["root"] / "input")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        process.main(args + ["--output-dir", "unused"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        process.main(args + ["--output-dir", "unused", "--device", "cuda"])
