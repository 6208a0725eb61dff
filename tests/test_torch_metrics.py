"""The port's segmentation metrics against the JAX package's.

Host metrics run the same numpy/scipy code on the same seeded masks, so
they agree exactly or to 1e-12; `tests/fixtures/metric_goldens.json` pins
the port to medpy's conventions as it pins the JAX package. `dice_torch`
sums in fp32 as `dice_jax` does: 1e-6, with the same empty conventions.
"""

import importlib.util
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.metrics import segmentation as jm
from waveformer_tpu_torch.metrics import segmentation as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (20, 24, 18)
SPACINGS = [None, (1.5, 1.0, 2.0)]


def _blob(rng, shape=SHAPE):
    c = [rng.integers(4, n - 4) for n in shape]
    r = rng.uniform(3, 7)
    grid = np.ogrid[tuple(slice(0, n) for n in shape)]
    mask = sum((g - ci) ** 2 for g, ci in zip(grid, c)) < r**2
    return mask | (rng.random(shape) < 0.01)


def _pairs():
    rng = np.random.default_rng(11)
    pairs = [(_blob(rng), _blob(rng)) for _ in range(4)]
    empty, full = np.zeros(SHAPE, bool), np.ones(SHAPE, bool)
    pairs += [(empty, _blob(rng)), (_blob(rng), empty), (empty, empty), (full, _blob(rng))]
    return pairs


PAIRS = _pairs()


def _labels(seed):
    rng = np.random.default_rng(seed)
    lab = np.zeros(SHAPE, np.uint8)
    for value in (2, 1, 3):
        lab[_blob(rng)] = value
    return lab


def _same(a, b):
    if isinstance(b, float) and math.isnan(b):
        return math.isnan(a)
    return a == b


@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_confusion_stats_and_dice_match_jax(i):
    p, g = PAIRS[i]
    got, want = tm.ConfusionStats(p, g), jm.ConfusionStats(p, g)
    for attr in ("tp", "fp", "fn", "tn", "n", "pred_empty", "pred_full", "gt_empty", "gt_full"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for rate in ("dice", "jaccard", "precision", "recall", "specificity", "accuracy",
                 "fscore", "false_positive_rate", "false_omission_rate",
                 "false_negative_rate", "true_negative_rate", "false_discovery_rate",
                 "negative_predictive_value"):
        assert getattr(got, rate)() == getattr(want, rate)(), rate
    assert got.fscore(beta=2.0) == want.fscore(beta=2.0)
    assert tm.dice(p, g) == jm.dice(p, g)


@pytest.mark.parametrize("spacing", SPACINGS)
@pytest.mark.parametrize("i", range(4))
def test_surface_distances_match_jax(i, spacing):
    p, g = PAIRS[i]
    np.testing.assert_array_equal(tm.surface_distances(p, g, spacing),
                                  jm.surface_distances(p, g, spacing))
    for name in ("hausdorff_distance_95", "hausdorff_distance", "average_surface_distance",
                 "average_surface_distance_symmetric"):
        got, want = getattr(tm, name)(p, g, spacing), getattr(jm, name)(p, g, spacing)
        assert abs(got - want) <= 1e-12, name


def test_surface_distance_of_empty_mask_raises():
    p, g = PAIRS[4]
    with pytest.raises(ValueError):
        tm.surface_distances(p, g)


def test_registry_keys_match_jax():
    assert list(tm.ALL_METRICS) == list(jm.ALL_METRICS)


@pytest.mark.parametrize("nan_for_nonexisting", [True, False])
@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_evaluate_metrics_matches_jax(i, nan_for_nonexisting):
    p, g = PAIRS[i]
    names = list(jm.ALL_METRICS)
    kw = dict(voxel_spacing=SPACINGS[1], nan_for_nonexisting=nan_for_nonexisting)
    got = tm.evaluate_metrics(p, g, names, **kw)
    want = jm.evaluate_metrics(p, g, names, **kw)
    assert list(got) == list(want)
    for name in names:
        assert _same(got[name], want[name]) or abs(got[name] - want[name]) <= 1e-12, name
    with pytest.raises(KeyError):
        tm.evaluate_metrics(p, g, ["Nope"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brats_and_multiclass_case_metrics_match_jax(seed):
    gt, pred = _labels(seed), _labels(seed + 10)
    np.testing.assert_array_equal(tm.convert_labels_brats(gt), jm.convert_labels_brats(gt))
    for spacing in ((1.0, 1.0, 1.0), (1.5, 1.0, 2.0)):
        np.testing.assert_allclose(tm.brats_case_metrics(gt, pred, spacing),
                                   jm.brats_case_metrics(gt, pred, spacing), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tm.multiclass_case_metrics(gt, pred, 4, spacing),
                                   jm.multiclass_case_metrics(gt, pred, 4, spacing),
                                   rtol=0, atol=1e-12)
    empty = np.zeros(SHAPE, np.float32)
    np.testing.assert_array_equal(tm.cal_metric(empty, pred == 1), jm.cal_metric(empty, pred == 1))
    np.testing.assert_array_equal(tm.cal_metric(empty, pred == 1), [0.0, 50.0])


def test_metric_goldens():
    with open(os.path.join(REPO, "tests", "fixtures", "metric_goldens.json")) as f:
        goldens = json.load(f)
    spec = importlib.util.spec_from_file_location(
        "gen_metric_goldens", os.path.join(REPO, "tools", "gen_metric_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cases = {name: (p, g, sp) for name, p, g, sp in mod.cases()}
    assert set(goldens) == set(cases)
    for name, vals in goldens.items():
        p, g, sp = cases[name]
        np.testing.assert_allclose(tm.dice(p, g), vals["dice"], rtol=1e-12, err_msg=name)
        for fn, key in ((tm.hausdorff_distance, "hd"), (tm.hausdorff_distance_95, "hd95"),
                        (tm.average_surface_distance, "asd"),
                        (tm.average_surface_distance_symmetric, "assd")):
            np.testing.assert_allclose(fn(p, g, sp), vals[key], rtol=1e-10, err_msg=name)


@pytest.mark.parametrize("dtype", [np.bool_, np.float32, np.uint8])
def test_dice_torch_matches_dice_jax(dtype):
    p = np.stack([a for a, _ in PAIRS]).astype(dtype)
    g = np.stack([b for _, b in PAIRS]).astype(dtype)
    got = tm.dice_torch(torch.from_numpy(p), torch.from_numpy(g))
    want = np.asarray(jm.dice_jax(jnp.asarray(p), jnp.asarray(g)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(PAIRS),)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the conventions: pair 4 and 5 have one empty mask, pair 6 both
    np.testing.assert_array_equal(got.numpy()[4:7], [0.0, 0.0, 1.0])
    host = [tm.dice(a, b) for a, b in PAIRS[:4]]
    np.testing.assert_allclose(got.numpy()[:4], host, rtol=0, atol=1e-6)
