"""The port's training and TTA measurement tools
(`waveformer_tpu_torch/tools/bench_train.py`, `bench_tta.py`) on the CPU
at a tiny size, against the JAX package where they compute something.

Setup: the e2e test's small network (dims 8/16/32/64, depths 1, roi 32³,
drop path 0) with seeded numpy weights in the JAX params' shapes, carried
into the port by `utils/jax_params.state_dict_from_jax`.

- `bench_train --device-only`: the first step of the tool's bf16 module on
  fp32 masters against JAX's `make_train_step` on the same weights and the
  JAX tool's batch (`numpy.random.default_rng(0)` standard normal data,
  zero labels), at `tests/test_torch_training.py`'s bf16 limits: the loss
  within 1e-3 relative and the unclipped gradient norm within 1e-2 of the
  fp32 norm. The JAX step runs in fp32: JAX's bf16 step reduces the bias
  gradients in bf16, and on this all-background batch its output conv's
  bias gradient comes out 0.0146 where the fp32 one is 1.053, so its bf16
  norm falls 14% below the fp32 norm (1.771 against 2.060; the port's bf16
  norm is 2.060). `--remat` gives the same first loss to 1e-6 relative
  (the same forward, recomputed in the backward).
- `bench_tta`: the tool's warm-up label map at `--tta 2` at least 99.9%
  equal to JAX's `Predictor.predict_case` with the inferer's
  `mirror_axes=(0,)`, in fp32 (sums in other orders may flip a near tie).
- Both tools' lines carry the JAX tools' keys (less the TPU fleet
  projection) and the port's additions.

Each JAX comparison compiles one program (`jax.jit` of the train step, the
inferer's jitted window loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.inference import Predictor as JaxPredictor
from waveformer_tpu.inference import SlidingWindowInferer as JaxInferer
from waveformer_tpu.models import Waveformer as JaxWaveformer
from waveformer_tpu.training import losses as jl
from waveformer_tpu.training import state as jstate
from waveformer_tpu_torch.config import Config
from waveformer_tpu_torch.tools import bench_train, bench_tta
from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax

SMALL = dict(img_size=(32, 32, 32), patch_size=2, in_chans=4, out_chans=4,
             embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8),
             decom_levels=(3, 2, 1, 0), drop_path_rate=0.0)
PATCH = (32, 32, 32)
# (C, D, H, W) of the TTA cases and the pipeline mode's training cases
CASE_SHAPE = (4, 40, 36, 34)
BF16_TOL = {"loss_rel": 1e-3, "grad_norm_fp32_rel": 1e-2}
REMAT_LOSS_REL = 1e-6
LABEL_AGREEMENT = 0.999

TRAIN_KEYS_JAX = {
    "device_only": {"mode", "batch", "remat", "ms_per_step", "steps_per_s"},
    "pipeline": {"mode", "aug", "batch", "window", "remat", "workers", "nproc_host",
                 "epoch_secs", "warm_steps_per_s", "warm_ms_per_step"},
}
TRAIN_KEYS_ADDED = {
    "device_only": {"device_ms_per_step", "peak_mem_gib", "loss_first", "loss_last",
                    "grad_norm_first"},
    "pipeline": {"loader_wait_share", "peak_mem_gib", "cpus_usable", "loss_count", "losses_finite"},
}
# the small network in fp32 with a 32³ prediction patch, for `bench.setup`
TINY_CONFIG = Config.from_dict({
    "compute_dtype": "float32",
    "prediction": {"patch_size": list(PATCH)},
    "network": {"in_channels": 4, "out_channels": 4, "img_size": list(PATCH), "patch_size": 2,
                "transformer": {"embed_dims": [8, 16, 32, 64], "depths": [1, 1, 1, 1],
                                "num_heads": [2, 4, 8, 8], "decom_levels": [3, 2, 1, 0],
                                "drop_path_rate": 0.0}},
})
TTA_KEYS = {"tta", "cases_per_s_chip", "s_per_case", "streams", "warmup_s"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the tier-1 run puts six pytest workers on
    the cores, and torch's thread pools then contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_params(module, x, seed=0):
    """Seeded numpy parameters in the shapes `module.init` would make."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "relative_position_bias_table":
            return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = max(int(np.prod(s.shape[:-1])), 1)
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_tool_batch(batch=1):
    """The JAX tool's resident batch (`tools/bench_train.py:89-93`) at PATCH."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((batch, *PATCH, SMALL["in_chans"])).astype(np.float32),
            np.zeros((batch, *PATCH, 1), np.int32))


@pytest.fixture(scope="module")
def carried():
    """The small network's seeded weights: the JAX params and the port's
    state dict."""
    data, _ = jax_tool_batch()
    params = seeded_params(JaxWaveformer(**SMALL), jnp.asarray(data))
    return params, state_dict_from_jax(params, SMALL["depths"])


def run_device_only(weights, *flags):
    return bench_train.main(["--device-only", "--steps", "1", "--device", "cpu", *flags],
                            network=SMALL, patch=PATCH, weights=weights)


def test_bench_train_device_only_first_step_matches_jax(carried):
    params, sd = carried
    line = run_device_only(sd)
    assert set(line) >= TRAIN_KEYS_JAX["device_only"] | TRAIN_KEYS_ADDED["device_only"]
    assert line["mode"] == "device_only" and line["batch"] == 1 and line["remat"] is False
    assert line["ms_per_step"] > 0 and line["steps_per_s"] > 0
    assert line["device_ms_per_step"] is None and line["peak_mem_gib"] is None  # CPU
    assert np.isfinite([line["loss_first"], line["loss_last"]]).all()

    data, seg = jax_tool_batch()
    jax_state = jstate.TrainState.create(params, jstate.make_optimizer(
        lr=1e-4, weight_decay=1e-2, grad_clip_norm=12.0))
    step = jstate.make_train_step(JaxWaveformer(**SMALL).apply,
                                  lambda lg, s: jl.dice_ce_loss(lg, s), donate=False)
    _, m = step(jax_state, {"data": jnp.asarray(data), "seg": jnp.asarray(seg)},
                jax.random.PRNGKey(0))
    loss_jax, norm_jax = float(m["loss"]), float(m["grad_norm"])

    loss, norm = line["loss_first"], line["grad_norm_first"]
    assert abs(loss - loss_jax) <= BF16_TOL["loss_rel"] * abs(loss_jax), (loss, loss_jax)
    assert abs(norm - norm_jax) <= BF16_TOL["grad_norm_fp32_rel"] * norm_jax, (norm, norm_jax)


def test_bench_train_remat_gives_the_same_first_loss(carried):
    _, sd = carried
    plain = run_device_only(sd)
    remat = run_device_only(sd, "--remat")
    assert remat["remat"] is True
    assert abs(remat["loss_first"] - plain["loss_first"]) <= (
        REMAT_LOSS_REL * abs(plain["loss_first"]))


def test_bench_train_pipeline_line():
    line = bench_train.main(["--steps", "2", "--epochs", "2", "--workers", "1",
                             "--window", "1", "--device", "cpu"],
                            network=SMALL, patch=PATCH, case_shape=CASE_SHAPE)
    assert set(line) >= TRAIN_KEYS_JAX["pipeline"] | TRAIN_KEYS_ADDED["pipeline"]
    assert (line["mode"], line["aug"], line["batch"], line["window"], line["workers"]) == (
        "pipeline", "train_fast", 1, 1, 1)
    assert len(line["epoch_secs"]) == 2 and all(s > 0 for s in line["epoch_secs"])
    assert line["warm_ms_per_step"] == pytest.approx(1e3 / line["warm_steps_per_s"])
    assert 0.0 <= line["loader_wait_share"] <= 1.0
    assert line["loss_count"] == 4 and line["losses_finite"]
    assert line["peak_mem_gib"] is None  # CPU


def test_bench_tta_labels_match_jax_predictor(carried):
    params, sd = carried
    lines, labels = bench_tta.main(["--tta", "2", "--cases", "1", "--device", "cpu"],
                                   case_shape=CASE_SHAPE, cfg=TINY_CONFIG, weights=sd)
    (line,) = lines
    assert set(line) == TTA_KEYS and line["tta"] == 2
    assert len(line["streams"]) == 3
    assert line["cases_per_s_chip"] == pytest.approx((line["streams"][1] + line["streams"][2]) / 2)
    assert line["s_per_case"] == pytest.approx(1 / line["cases_per_s_chip"])
    got = labels[2]
    assert got.shape == CASE_SHAPE[1:]

    vol = np.random.default_rng(0).standard_normal(CASE_SHAPE).astype(np.float32)
    jm = JaxWaveformer(**SMALL, io_layout="channels_first")
    inferer = JaxInferer(roi_size=PATCH, sw_batch_size=8, overlap=0.5, mirror_axes=(0,),
                         layout="channels_first", tta_mode="patch")
    want = JaxPredictor(inferer).predict_case(vol, lambda p: jm.apply(params, p), 4)
    assert np.mean(got == np.asarray(want)) >= LABEL_AGREEMENT


def test_bench_tta_axes_are_the_jax_tools():
    assert bench_tta.AXES == {1: None, 2: (0,), 4: (0, 1), 8: (0, 1, 2)}
