"""The port's SSL entry point against the JAX package's, on the CPU.

`waveformer_tpu_torch.scripts.pretrain_ssl.main` and the JAX script run with
the same flags (tiny widths, 2 steps, validation every step, inline loaders)
in both data modes: `--data-dir` over seeded preprocessed cases from
`tools/synthetic_cases.py`, and `--datalist-json` over CT-like NIfTI volumes
with no `validation` key (the first tenth of the list validates). The two
write checkpoints of the same names and the same flax keys and shapes, and
finite losses; the port's final checkpoint is its trainer's masters.
"""

import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from waveformer_tpu.scripts import pretrain_ssl as jscript
from waveformer_tpu_torch.scripts import pretrain_ssl as tscript
from waveformer_tpu_torch.tools import synthetic_cases
from waveformer_tpu_torch.training.checkpoint import load_params_npz
from waveformer_tpu_torch.utils import nifti
from waveformer_tpu_torch.utils.jax_params import ssl_state_dict_from_jax

FLAGS = ["--num-steps", "2", "--batch-size", "2", "--patch-size", "16", "16", "16",
         "--vit-patch", "8", "--hidden-size", "16", "--num-layers", "1", "--num-heads", "2",
         "--warmup-steps", "1", "--eval-every", "1", "--num-workers", "0", "--seed", "3"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both scripts in both modes: {(package, mode): (logdir, trainer or None)}."""
    root = tmp_path_factory.mktemp("pretrain")
    synthetic_cases.write_training_cases(str(root / "fullres"), n=4, shape=(40, 44, 36), seed=0)
    os.makedirs(root / "ct")
    rng = np.random.default_rng(1)
    for i in range(3):
        vol = np.full((30, 28, 24), -1000, np.int16)
        vol[4:26, 5:23, 3:21] = rng.integers(-100, 200, (22, 18, 18))
        nifti.save(nifti.NiftiImage(data=vol), str(root / "ct" / f"ct_{i}.nii.gz"))
    js = root / "dataset.json"
    js.write_text(json.dumps({"training": [f"ct/ct_{i}.nii.gz" for i in range(3)]}))
    modes = {"data_dir": ["--data-dir", str(root / "fullres")],
             "datalist": ["--datalist-json", str(js), "--cache-rate", "1"]}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setenv("WFTPU_NO_COMPILE_CACHE", "1")  # the JAX script's XLA cache
    out = {}
    try:
        for mode, args in modes.items():
            for name, script in (("jax", jscript), ("port", tscript)):
                logdir = str(root / f"{name}_{mode}")
                extra = ["--platform", "cpu"] if name == "jax" else ["--device", "cpu"]
                out[name, mode] = (logdir, script.main(args + FLAGS + ["--logdir", logdir] + extra))
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return out


def _checkpoints(logdir):
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(logdir, "model", "*.npz")))


def _keys_shapes(path):
    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), v.shape

    return dict(flat(load_params_npz(path)["params"]))


@pytest.mark.parametrize("mode", ["data_dir", "datalist"])
def test_checkpoints_match_jax(runs, mode):
    (jdir, _), (tdir, trainer) = runs["jax", mode], runs["port", mode]
    jnames, tnames = _checkpoints(jdir), _checkpoints(tdir)
    pattern = re.compile(r"best_model_-?\d+\.\d{4}_ssl_vit\.npz")
    for names in (jnames, tnames):
        assert len(names) == 2 and pattern.fullmatch(names[0])
        assert names[1] == "final_model_0.0000_ssl_vit.npz"
    assert tnames[0] == f"best_model_{-trainer.best_val:.4f}_ssl_vit.npz"
    for j, t in zip(jnames, tnames):
        assert _keys_shapes(os.path.join(tdir, "model", t)) == \
            _keys_shapes(os.path.join(jdir, "model", j))
    # datalist mode reads one channel, the preprocessed cases four
    want_c = 1 if mode == "datalist" else 4
    assert trainer.model.in_channels == want_c
    sd = ssl_state_dict_from_jax(load_params_npz(os.path.join(tdir, "model", tnames[1])))
    for n, m in trainer.state.params.items():
        assert torch.equal(sd[n], m), n


@pytest.mark.parametrize("mode", ["data_dir", "datalist"])
def test_losses_finite(runs, mode):
    for name in ("jax", "port"):
        logdir, _ = runs[name, mode]
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        tags = {r["tag"] for r in rows}
        assert {"loss", "contrast", "recon", "val_recon_l1"} <= tags, (name, tags)
        assert np.isfinite([r["value"] for r in rows]).all(), name
        assert os.path.exists(os.path.join(logdir, "pretrain.log"))


def test_port_trains_in_bf16_and_times_steps(runs):
    _, trainer = runs["port", "data_dir"]
    assert trainer.device.type == "cpu" and trainer.state.step == 2
    assert trainer.model.compute_dtype == torch.bfloat16
    assert all(m.dtype == torch.float32 for m in trainer.state.params.values())
    assert len(trainer.step_times) == 2
    assert all(0 <= wait <= total for total, wait in trainer.step_times)


def test_device_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tscript.main(["--data-dir", str(tmp_path), "--logdir", str(tmp_path / "logs")])


def test_needs_exactly_one_data_source(tmp_path):
    with pytest.raises(SystemExit):
        tscript.main(["--device", "cpu", "--logdir", str(tmp_path / "logs")])
