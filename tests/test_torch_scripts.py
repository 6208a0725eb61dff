"""The serving slice end to end on the CPU: the port's predict and metrics
scripts against the JAX package's, on one seeded dataset.

Setup: the e2e test's small network (dims 8/16/32/64, depths 1, roi 32³),
two seeded preprocessed cases of about (4, 40, 44, 36) with their
properties (one of them resampled to another crop shape), raw ground
truth NIfTIs under a non-RAS source affine, and JAX parameters from
`model.init` saved with the JAX package's `save_params_npz`. Both
`scripts.predict.main` run in fp32 at `--tta 2`; the label maps agree on
at least 99.9% of the voxels, and a voxel may differ only where the port's
two top logits are within 2e-4 (fp32 sums in other orders). The affines
agree to 1e-6. The port's `compute_metrics` on the JAX predictions equals
the JAX `.npy` to 1e-12. The port's bench line is held to its schema at a
tiny size.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.config import load_config as jax_load_config
from waveformer_tpu.models import create_waveformer as jax_create_waveformer
from waveformer_tpu.scripts import compute_metrics as jax_metrics
from waveformer_tpu.scripts import predict as jax_predict
from waveformer_tpu.training.checkpoint import save_params_npz as jax_save_params_npz
from waveformer_tpu.utils import nifti as jax_nifti
from waveformer_tpu_torch import bench
from waveformer_tpu_torch.config import load_config
from waveformer_tpu_torch.inference import Predictor, SlidingWindowInferer
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.scripts import compute_metrics, predict
from waveformer_tpu_torch.tools import synthetic_cases
from waveformer_tpu_torch.training.checkpoint import load_params_npz
from waveformer_tpu_torch.utils import nifti
from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax

# source voxel order (X, Y, Z) of the raw volumes; canonical (D, H, W) is
# (Z, Y, X) after the flips that diag(-1, -1, 1) asks for
RAW_SHAPE = (46, 50, 42)
SOURCE_AFFINE = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
SOURCE_AFFINE[:3, 3] = (45.0, 49.0, -3.0)
# each case's crop of the canonical (D, H, W) = (42, 50, 46) volume, and the
# shape it is stored at: the second one's logits are resampled to its crop
BBOXES = [((1, 41), (3, 47), (5, 41)), ((2, 40), (2, 48), (6, 42))]
STORED = [(40, 44, 36), (40, 44, 36)]
LABEL_AGREEMENT = 0.999
TIE_TOL = 2e-4


def _config_text(root, out, tag):
    return f"""\
data_dir: "{root}/fullres"
logdir: "{root}/logs/"
raw_data_dir: "{root}/raw"
model_name: "serving_test"
data_list_path: "{root}/data_list"
split_path: "default_split"
roi_size: [32, 32, 32]
seed: 42
compute_dtype: "float32"
label_mode: "brats"
prediction:
  patch_size: [32, 32, 32]
  sw_batch_size: 4
  overlap: 0.25
  mirror_axes: [0, 1, 2]
  raw_spacing: [1.0, 1.0, 1.0]
  prediction_save: "{out}"
logging:
  log_file: "{root}/logs/{tag}.log"
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
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both predict scripts run once on one tree; returns its paths."""
    root = str(tmp_path_factory.mktemp("serving"))
    names = synthetic_cases.write_cases(root, np.random.default_rng(3), RAW_SHAPE, BBOXES,
                                        SOURCE_AFFINE, STORED)
    paths = {"root": root, "names": names}
    for tag in ("jax", "port"):
        paths[tag] = os.path.join(root, f"pred_{tag}")
        paths[f"{tag}_config"] = os.path.join(root, f"config_{tag}.yaml")
        with open(paths[f"{tag}_config"], "w") as f:
            f.write(_config_text(root, paths[tag], tag))
    cfg = jax_load_config(paths["jax_config"])
    model = jax_create_waveformer(cfg.network.model_kwargs(), dtype=jnp.float32,
                                  io_layout="channels_first")
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 32)))
    jax_save_params_npz(params, os.path.join(root, "logs", "model",
                                             "best_model_0.5000_serving_test.npz"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WFTPU_NO_COMPILE_CACHE", "1")  # no persistent XLA cache in HOME
        jax_predict.main(["--config", paths["jax_config"], "--platform", "cpu", "--tta", "2"])
    paths["port_summary"] = predict.main(
        ["--config", paths["port_config"], "--device", "cpu", "--tta", "2"])
    return paths


def _port_case(paths, name):
    """The port's model and predictor as the script builds them (CPU,
    `--tta 2`), with the case's volume and properties."""
    cfg = load_config(paths["port_config"])
    model = create_waveformer(cfg.network.model_kwargs(), device="cpu",
                              io_layout="channels_first")
    t = cfg.network.transformer
    model.load_state_dict(state_dict_from_jax(load_params_npz(
        os.path.join(paths["root"], "logs", "model", "best_model_0.5000_serving_test.npz")),
        t.depths, t.hf_refinement))
    inferer = SlidingWindowInferer(cfg.prediction.patch_size, cfg.prediction.sw_batch_size,
                                   cfg.prediction.overlap, mirror_axes=(0,),
                                   tta_mode="patch", layout="channels_first")
    fullres = os.path.join(paths["root"], "fullres")
    with open(os.path.join(fullres, name + ".pkl"), "rb") as f:
        props = pickle.load(f)
    vol = np.load(os.path.join(fullres, name + ".npy"))
    return model, Predictor(inferer, device="cpu"), vol, props


def test_predict_scripts_agree(served):
    assert served["port_summary"]["cases"] == len(BBOXES)
    for name in served["names"]:
        want = jax_nifti.load(os.path.join(served["jax"], name + ".nii.gz"))
        got = nifti.load(os.path.join(served["port"], name + ".nii.gz"))
        assert got.data.shape == want.data.shape == RAW_SHAPE
        assert got.data.dtype == want.data.dtype == np.uint8
        np.testing.assert_allclose(got.affine, want.affine, atol=1e-6)
        np.testing.assert_allclose(got.affine, SOURCE_AFFINE, atol=1e-6)
        differ = got.data != want.data
        assert 1.0 - differ.mean() >= LABEL_AGREEMENT, (name, differ.sum())
        if differ.any():  # flips only at near-ties of the port's two top logits
            model, pred, vol, props = _port_case(served, name)
            with torch.inference_mode():
                logits = pred.resample_logits_to_crop(
                    pred.predict_logits(torch.from_numpy(vol), model, 4), props)
            ornt = np.asarray(props["orientation"])
            flip_dhw = nifti.apply_orientation(differ, ornt).T
            bbox = props["bbox_used_for_cropping"]
            crop = flip_dhw[tuple(slice(b0, b1) for b0, b1 in bbox)]
            assert crop.sum() == differ.sum(), "a label differs outside the crop"
            top2 = np.sort(logits[:, crop], axis=0)[-2:]
            assert float((top2[1] - top2[0]).max()) <= TIE_TOL


def test_port_labels_equal_in_memory_predictor(served):
    """The script's file is `predict_case` + `save_to_nii` of the same model."""
    name = served["names"][1]
    model, pred, vol, props = _port_case(served, name)
    out = os.path.join(served["root"], "in_memory.nii.gz")
    pred.save_to_nii(pred.predict_case(vol, model, 4, props), out, properties=props)
    want = nifti.load(os.path.join(served["port"], name + ".nii.gz"))
    got = nifti.load(out)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.affine, want.affine)


def test_compute_metrics_matches_jax(served, capsys):
    jax_out = os.path.join(served["root"], "metrics_jax.npy")
    port_out = os.path.join(served["root"], "metrics_port.npy")
    jax_metrics.main(["--config", served["jax_config"], "--out", jax_out])
    jax_text = capsys.readouterr().out
    got = compute_metrics.main(["--config", served["port_config"], "--pred-dir",
                                served["jax"], "--out", port_out, "--device", "cpu"])
    port_text = capsys.readouterr().out
    want = np.load(jax_out)
    assert want.shape == (len(BBOXES), 3, 2) and np.isfinite(want).all()
    np.testing.assert_allclose(np.load(port_out), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert port_text == jax_text


def test_bench_line_schema(served, capsys):
    cfg_path = served["port_config"]
    line = bench.main(["--device", "cpu", "--config", cfg_path],
                      case_shape=(4, 30, 32, 28), stream_cases=2)
    first = capsys.readouterr().out.splitlines()[0]
    assert json.loads(first) == line
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "streams"}
    assert line["metric"] == "brats_fullcase_sliding_window_inference"
    assert len(line["streams"]) == 3 and all(r > 0 for r in line["streams"])
    assert abs(line["value"] - (line["streams"][1] + line["streams"][2]) / 2) <= 1e-4
    assert abs(line["vs_baseline"] - line["value"] / 1.92) <= 1e-4
    assert line["unit"].startswith("cases/sec/card (cpu;")
