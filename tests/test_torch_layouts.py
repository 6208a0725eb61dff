"""The port's entry points with their default layouts against the JAX
package's defaults: channels-last (D, H, W, C) volumes through
`SlidingWindowInferer()` and `Predictor`, and a (B, D, H, W, C) patch through
`create_waveformer(cfg)`, as JAX's `Waveformer(**cfg)` takes it.

The toy predictor is the one of `tests/test_torch_inference.py` written for
channels-last patches (not flip-equivariant, so mirror TTA matters); logits
agree to 1e-5 as there, the toy model's to 2e-4 as in
`tests/test_torch_model.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.inference import predictor as jpred
from waveformer_tpu.inference import sliding_window as jsw
from waveformer_tpu.models import Waveformer as JaxWaveformer
from waveformer_tpu_torch.inference import predictor as tpred
from waveformer_tpu_torch.inference import sliding_window as tsw
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.utils import jax_params as jp
from test_torch_model import SMALL, random_params

ROI = (16, 16, 16)
OUT = 3
_rng = np.random.default_rng(11)
MIX = _rng.standard_normal((OUT, 2)).astype(np.float32)
RAMP = _rng.standard_normal(ROI).astype(np.float32)


def jax_toy(p):  # (B, *roi, C) → (B, *roi, OUT)
    return (jnp.einsum("bdhwc,oc->bdhwo", jnp.tanh(p), jnp.asarray(MIX))
            + p[..., :1] * jnp.asarray(RAMP)[..., None])


def torch_toy(p):
    return (torch.einsum("bdhwc,oc->bdhwo", torch.tanh(p), torch.from_numpy(MIX))
            + p[..., :1] * torch.from_numpy(RAMP)[..., None])


def _vol(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, dict(mirror_axes=(0, 1, 2), tta_mode="patch", sw_batch_size=3),
                                dict(mirror_axes=(1,), tta_mode="volume")])
def test_default_inferer_matches_jax(kw):
    v = _vol((20, 24, 18, 2))
    jinf, tinf = jsw.SlidingWindowInferer(ROI, **kw), tsw.SlidingWindowInferer(ROI, **kw)
    assert tinf.layout == jinf.layout == "channels_last"
    want = np.asarray(jinf(jnp.asarray(v), jax_toy, OUT))
    got = tinf(torch.from_numpy(v), torch_toy, OUT)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (20, 24, 18, OUT)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_asymmetric_grid_channels_last_matches_jax():
    v = _vol((28, 16, 16, 2), 1)  # starts 0, 8, 12 along D: not mirror-symmetric
    kw = dict(roi_size=ROI, out_channels=OUT, overlap=0.5, sw_batch_size=2,
              mirror_axes=(0, 1, 2), tta_mode="patch")
    want = np.asarray(jsw.sliding_window_inference(jnp.asarray(v), jax_toy, **kw))
    got = tsw.sliding_window_inference(torch.from_numpy(v), torch_toy, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


PROPS = {
    "shape_before_cropping": (30, 34, 28),
    "bbox_used_for_cropping": [[2, 24], [5, 31], [3, 23]],
    "shape_after_cropping_and_before_resampling": (22, 26, 20),
}


def test_default_predictor_matches_jax():
    v = _vol((20, 24, 18, 2), 2)
    kw = dict(sw_batch_size=4, mirror_axes=(0, 1, 2), tta_mode="patch")
    want = jpred.Predictor(jsw.SlidingWindowInferer(ROI, **kw)).predict_case(
        v, jax_toy, OUT, PROPS)
    port = tpred.Predictor(tsw.SlidingWindowInferer(ROI, **kw), device="cpu")
    got = port.predict_case(v, torch_toy, OUT, PROPS)
    assert got.shape == want.shape == (30, 34, 28) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    logits = port.resample_logits_to_crop(
        port.predict_logits(torch.from_numpy(v), torch_toy, OUT), PROPS)
    assert logits.shape == (22, 26, 20, OUT)
    # no resample: the label map at the volume's own shape, argmax over the last axis
    np.testing.assert_array_equal(port.predict_case(v, torch_toy, OUT),
                                  jpred.Predictor(jsw.SlidingWindowInferer(ROI, **kw))
                                  .predict_case(v, jax_toy, OUT))


def test_unknown_layout_raises():
    with pytest.raises(ValueError):
        tsw.SlidingWindowInferer(ROI, layout="ncdhw")
    with pytest.raises(ValueError):
        create_waveformer(dict(img_size=(32, 32, 32)), device="cpu", io_layout="ncdhw")


@pytest.mark.parametrize("variant", [{}, {"multi_scale_attention": False}])
def test_default_model_layout_matches_jax(variant):
    cfg = dict(SMALL, **variant)
    x = _vol((1, 32, 32, 32, 2), 3)
    jm = JaxWaveformer(**cfg)
    assert jm.io_layout == "channels_last"
    p = random_params(jm, jnp.asarray(x))
    tm = create_waveformer(cfg, device="cpu")
    assert tm.io_layout == "channels_last"
    tm.load_state_dict(jp.state_dict_from_jax(p, depths=cfg["depths"]), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 32, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x))),
                               atol=2e-4)


def test_layouts_share_parameters_and_logits():
    """One set of weights under both layouts: the same state_dict keys, and
    logits (deep supervision heads included) that are transposes."""
    cl = create_waveformer(dict(SMALL, deep_supervision=True), device="cpu", seed=0)
    cf = create_waveformer(dict(SMALL, deep_supervision=True), device="cpu", seed=0,
                           io_layout="channels_first")
    assert list(cl.state_dict()) == list(cf.state_dict())
    cf.load_state_dict(cl.state_dict(), strict=True)
    x = torch.from_numpy(_vol((1, 32, 32, 32, 2), 4))
    with torch.no_grad():
        outs_cl = cl(x)
        outs_cf = cf(x.permute(0, 4, 1, 2, 3))
    assert [tuple(o.shape) for o in outs_cl] == [
        (1, 32, 32, 32, 3), (1, 16, 16, 16, 3), (1, 8, 8, 8, 3)]
    for a, b in zip(outs_cl, outs_cf):
        torch.testing.assert_close(a, b.permute(0, 2, 3, 4, 1), rtol=0, atol=1e-6)
