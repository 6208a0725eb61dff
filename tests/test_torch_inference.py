"""The port's sliding window and predictor against the JAX package.

A shared toy predictor (the same function written once in jnp and once in
torch, not flip-equivariant, so mirror TTA matters) stands in for the
model; volumes come from a seeded numpy generator. Blended logits agree
to 1e-5 (fp32 stitch sums in another order); label maps agree except
where two logits are within that noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.inference import predictor as jpred
from waveformer_tpu.inference import sliding_window as jsw
from waveformer_tpu_torch.inference import predictor as tpred
from waveformer_tpu_torch.inference import sliding_window as tsw
from waveformer_tpu_torch.models import create_waveformer

ROI = (16, 16, 16)
OUT = 3
_rng = np.random.default_rng(7)
MIX = _rng.standard_normal((OUT, 2)).astype(np.float32)
RAMP = _rng.standard_normal(ROI).astype(np.float32)


def jax_toy(p):
    return (jnp.einsum("bcdhw,oc->bodhw", jnp.tanh(p), jnp.asarray(MIX))
            + p[:, :1] * jnp.asarray(RAMP))


def torch_toy(p):
    return (torch.einsum("bcdhw,oc->bodhw", torch.tanh(p), torch.from_numpy(MIX))
            + p[:, :1] * torch.from_numpy(RAMP))


def _vol(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_host_helpers_match_jax():
    for img, ov in (((20, 24, 18), 0.5), ((150, 180, 145), 0.5), ((28, 16, 40), 0.25)):
        roi = ROI if img[0] < 100 else (128, 128, 128)
        np.testing.assert_array_equal(tsw.dense_patch_starts(img, roi, ov),
                                      jsw.dense_patch_starts(img, roi, ov))
        assert tsw.bucket_shape(img, roi, ov) == jsw.bucket_shape(img, roi, ov)
        assert tsw.scan_interval(roi, ov) == jsw.scan_interval(roi, ov)
    np.testing.assert_array_equal(tsw.compute_importance_map(ROI),
                                  jsw.compute_importance_map(ROI))
    np.testing.assert_array_equal(tsw.count_map((24, 24, 24), ROI, 0.5),
                                  jsw.count_map((24, 24, 24), ROI, 0.5))


@pytest.mark.parametrize("mirror,tta_mode,sw_batch", [
    (None, "volume", 2), ((0, 1, 2), "patch", 3), ((0, 1, 2), "volume", 3), ((1,), "patch", 8),
])
def test_inferer_matches_jax(mirror, tta_mode, sw_batch):
    v = _vol((2, 20, 24, 18))
    kw = dict(roi_size=ROI, sw_batch_size=sw_batch, overlap=0.5, mirror_axes=mirror,
              tta_mode=tta_mode, layout="channels_first")
    want = np.asarray(jsw.SlidingWindowInferer(**kw)(jnp.asarray(v), jax_toy, OUT))
    got = tsw.SlidingWindowInferer(**kw)(torch.from_numpy(v), torch_toy, OUT)
    assert got.dtype == torch.float32 and tuple(got.shape) == (OUT, 20, 24, 18)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_patch_tta_falls_back_on_asymmetric_grid():
    v = _vol((2, 28, 16, 16), 1)  # starts 0, 8, 12 along D: not mirror-symmetric
    kw = dict(roi_size=ROI, out_channels=OUT, overlap=0.5, sw_batch_size=2,
              mirror_axes=(0, 1, 2), tta_mode="patch")
    want = np.asarray(jsw.sliding_window_inference(
        jnp.asarray(v), jax_toy, layout="channels_first", **kw))
    got = tsw.sliding_window_inference(torch.from_numpy(v), torch_toy, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


PROPS = {
    "shape_before_cropping": (30, 34, 28),
    "bbox_used_for_cropping": [[2, 24], [5, 31], [3, 23]],
    "shape_after_cropping_and_before_resampling": (22, 26, 20),
}


def test_predict_case_matches_jax():
    v = _vol((2, 20, 24, 18), 2)
    kw = dict(roi_size=ROI, sw_batch_size=4, overlap=0.5, mirror_axes=(0, 1, 2),
              tta_mode="patch", layout="channels_first")
    want = jpred.Predictor(jsw.SlidingWindowInferer(**kw)).predict_case(
        v, jax_toy, OUT, PROPS)
    port = tpred.Predictor(tsw.SlidingWindowInferer(**kw), device="cpu")
    got = port.predict_case(v, torch_toy, OUT, PROPS)
    assert got.shape == want.shape == (30, 34, 28) and got.dtype == np.uint8
    assert np.mean(got != want) < 1e-3
    logits = port.resample_logits_to_crop(
        port.predict_logits(torch.from_numpy(v), torch_toy, OUT), PROPS)
    assert logits.shape == (OUT, 22, 26, 20)


def test_predict_cases_pipeline_with_toy_model():
    cfg = dict(img_size=(32, 32, 32), in_chans=2, out_chans=3, embed_dims=(8, 16, 32, 64),
               depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8), drop_path_rate=0.0)
    model = create_waveformer(cfg, device="cpu", seed=0)
    inferer = tsw.SlidingWindowInferer((32, 32, 32), sw_batch_size=2, overlap=0.5,
                                       mirror_axes=(0,), tta_mode="patch")
    pred = tpred.Predictor(inferer, device="cpu")
    vols = [_vol((2, 40, 32, 30), s) for s in (3, 4)]
    segs = list(pred.predict_cases(vols, model, out_channels=3))
    for v, seg in zip(vols, segs):
        with torch.inference_mode():
            logits = inferer(torch.from_numpy(v), model, 3)
        np.testing.assert_array_equal(seg, torch.argmax(logits, 0).numpy().astype(np.uint8))
    np.testing.assert_array_equal(pred.predict_case(vols[1], model, 3), segs[1])


def test_largest_connected_component_matches_jax():
    seg = np.zeros((10, 10, 10), np.uint8)
    seg[1:3, 1:3, 1:3] = 1
    seg[5:9, 5:9, 5:9] = 2
    np.testing.assert_array_equal(tpred.largest_connected_component(seg),
                                  jpred.largest_connected_component(seg))


def test_predictor_refuses_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inferer = tsw.SlidingWindowInferer(ROI)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.Predictor(inferer)
    assert tpred.Predictor(inferer, device="cpu").device.type == "cpu"
