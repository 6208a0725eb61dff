"""The port's training entry point on the CPU, against the JAX package.

`waveformer_tpu_torch.scripts.train.main` runs on a tiny config (the e2e
test's small network at roi 32³, fp32, 2 epochs of 2 steps, validation every
epoch, inline loader, `--device cpu`) over seeded preprocessed cases from
`tools/synthetic_cases.py`. The `best_model_*.npz` it writes loads in the
JAX package's `load_params_npz`, and JAX's logits from it agree with the
port's to 2e-4 (the toy model's fp32 agreement); `--plans` feeds a plan's
patch size into the network, as the JAX script does.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.models import Waveformer as JaxWaveformer
from waveformer_tpu.training.checkpoint import load_params_npz as jax_load_params_npz
from waveformer_tpu_torch.config import load_config
from waveformer_tpu_torch.data.planning import Plans
from waveformer_tpu_torch.scripts import train
from waveformer_tpu_torch.tools import synthetic_cases

NET = dict(img_size=(32, 32, 32), patch_size=2, in_chans=4, out_chans=4,
           embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8),
           decom_levels=(3, 2, 1, 0), drop_path_rate=0.0)

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the tier-1 run puts six pytest
    workers on the cores, and torch's thread pools then contend (these small
    CPU steps ran 10-50× slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config_text(root, roi=32):
    return f"""\
data_dir: "{root}/fullres"
logdir: "{root}/logs/"
model_name: "train_test"
data_list_path: "{root}/data_list"
split_path: "default_split"
roi_size: [{roi}, {roi}, {roi}]
seed: 3
compute_dtype: "float32"
batch_size: 2
max_epoch: 2
num_steps_per_epoch: 2
val_every: 1
val_patches_per_epoch: 2
train_process: 0
lr: 0.0001
label_mode: "brats"
logging:
  log_file: "{root}/logs/train.log"
network:
  in_channels: 4
  out_channels: 4
  img_size: [{roi}, {roi}, {roi}]
  patch_size: 2
  transformer:
    embed_dims: [8, 16, 32, 64]
    depths: [1, 1, 1, 1]
    num_heads: [2, 4, 8, 8]
    decom_levels: [3, 2, 1, 0]
    drop_path_rate: 0.0
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_tree"))
    synthetic_cases.write_training_cases(os.path.join(root, "fullres"), n=4,
                                         shape=(40, 44, 36), seed=0)
    config = os.path.join(root, "config.yaml")
    with open(config, "w") as f:
        f.write(_config_text(root))
    trainer = train.main(["--config", config, "--device", "cpu"])
    return root, config, trainer


def test_script_trains_and_writes_checkpoints(trained):
    root, config, trainer = trained
    assert trainer.global_step == 4 and trainer.device.type == "cpu"
    with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(l) for l in f]
    losses = [r["value"] for r in rows if r["tag"] == "training_loss"]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert len(glob.glob(os.path.join(root, "logs", "model", "final_model_*.npz"))) == 1
    assert len(glob.glob(os.path.join(root, "logs", "model", "best_model_*.npz"))) == 1
    # the persisted split: 3 training cases, 1 validation case
    assert sorted(os.listdir(os.path.join(root, "data_list", "default_split"))) == [
        "train_list.pkl", "val_list.pkl"]
    assert glob.glob(os.path.join(root, "logs", "events.out.tfevents.*"))


def test_best_checkpoint_loads_in_jax(trained):
    root, config, trainer = trained
    (best,) = glob.glob(os.path.join(root, "logs", "model", "best_model_*.npz"))
    params = jax_load_params_npz(best)
    x = np.random.default_rng(5).standard_normal((1, 32, 32, 32, 4)).astype(np.float32)
    want = np.asarray(jax.jit(JaxWaveformer(**NET).apply)(params, jnp.asarray(x)))

    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.training.checkpoint import load_params_npz
    from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax

    model = create_waveformer(NET, device="cpu")
    model.load_state_dict(state_dict_from_jax(load_params_npz(best), NET["depths"]), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 32, 32, 32, 4)
    assert np.abs(got - want).max() <= 2e-4
    # the best file holds the masters of its epoch; the final one the
    # trainer's last weights
    meta = json.load(open(best + ".json"))
    if meta["epoch"] == trainer.epoch:
        with torch.no_grad():
            assert torch.equal(trainer.model(torch.from_numpy(x)), torch.from_numpy(got))


def test_resume_and_no_resume(trained, tmp_path):
    root, config, trainer = trained
    trainer.ckpt.save_state(trainer.state, 1)  # a periodic state after epoch 1
    cfg_text = open(config).read().replace("max_epoch: 2", "max_epoch: 3")
    config3 = str(tmp_path / "config3.yaml")
    with open(config3, "w") as f:
        f.write(cfg_text)
    resumed = train.main(["--config", config3, "--device", "cpu"])
    assert resumed.global_step == 6 and len(resumed.epoch_times) == 1
    fresh = train.main(["--config", config3, "--device", "cpu", "--no-resume"])
    assert fresh.global_step == 6 and len(fresh.epoch_times) == 3


def test_plans_configure_the_network(trained, tmp_path):
    root, config, _ = trained
    plans_path = str(tmp_path / "plans.json")
    Plans.from_plan({"patch_size": [30, 31, 28], "target_spacing": [1.0, 1.0, 1.0]}).save(
        plans_path)
    cfg = Plans.load(plans_path).apply_to_config(load_config(config))
    assert cfg.roi_size == (32, 32, 32) and tuple(cfg.network.img_size) == (32, 32, 32)
    with pytest.raises(SystemExit):  # a plans file without a patch size is refused
        Plans.from_plan({"target_spacing": [1, 1, 1]}).save(plans_path)
        train.main(["--config", config, "--device", "cpu", "--plans", plans_path])


def test_script_refuses_silent_cpu(monkeypatch, trained):
    _, config, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config", config])
