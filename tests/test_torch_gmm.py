"""The port's Gaussian-mixture ops against the JAX package (CPU).

The port draws `gmm_fit`'s k initial rows from a CPU `torch.Generator`
(`_init_indices`); JAX draws them with `jax.random.choice`. The parity tests
replace `_init_indices` with JAX's draw, the one seam between the two, so
both fits start from the same rows. Tolerances: log-densities and
posteriors 1e-5 relative; parameters after 20 EM steps 1e-4 relative to
each array's largest value; labels equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.ops import gmm as jg
from waveformer_tpu_torch.ops import gmm as tg


@pytest.fixture
def jax_init(monkeypatch):
    def choice(n, k, seed):
        idx = jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False)
        return torch.from_numpy(np.asarray(idx).astype(np.int64))

    monkeypatch.setattr(tg, "_init_indices", choice)


def _clusters(seed=0, n=(300, 200), c=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0.0, 1.0, (n[0], c)),
                           rng.normal(4.0, 0.5, (n[1], c))]).astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * max(float(np.abs(want).max()), 1e-30)


def _params(seed=1):
    rng = np.random.default_rng(seed)
    w = np.array([0.7, 0.0, 0.3], np.float32)  # a zero weight: the 1e-12 floor
    means = rng.normal(0, 2, (3, 4)).astype(np.float32)
    var = rng.uniform(0.2, 2.0, (3, 4)).astype(np.float32)
    var[1, 2] = 1e-9  # below the 1e-6 floor
    return w, means, var


def test_log_prob_and_posterior_match_jax_with_their_floors():
    w, means, var = _params()
    x = np.random.default_rng(2).normal(0, 2, (50, 4)).astype(np.float32)
    jp = jg.GMMParams(*map(jnp.asarray, (w, means, var)))
    tp = tg.GMMParams(*map(torch.from_numpy, (w, means, var)))
    want = np.asarray(jg._log_prob(jp, jnp.asarray(x)))
    got = tg._log_prob(tp, torch.from_numpy(x))
    assert np.isfinite(got.numpy()).all()
    _close(got, want, 1e-5)
    _close(tg.gmm_posterior(tp, torch.from_numpy(x)), jg.gmm_posterior(jp, jnp.asarray(x)),
           1e-5)


def test_initial_params_are_the_population_variance_plus_1e_3(jax_init):
    """Zero EM steps: equal weights, the drawn rows, var(x) (ddof 0) + 1e-3."""
    x = _clusters(3)
    want = jg.gmm_fit(jnp.asarray(x), 3, n_iters=0, seed=5)
    got = tg.gmm_fit(torch.from_numpy(x), 3, n_iters=0, seed=5)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    np.testing.assert_allclose(got.variances.numpy()[0], x.var(axis=0) + 1e-3, rtol=1e-5)


@pytest.mark.parametrize("k,seed", [(2, 0), (3, 7)])
def test_gmm_fit_matches_jax_after_20_steps(jax_init, k, seed):
    x = _clusters(seed)
    want = jg.gmm_fit(jnp.asarray(x), k, 20, seed=seed)
    got = tg.gmm_fit(torch.from_numpy(x), k, 20, seed=seed)
    assert isinstance(got, tg.GMMParams)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_gmm_fit_recovers_two_clusters():
    """The port's own draw: the means land on the two clusters."""
    got = tg.gmm_fit(torch.from_numpy(_clusters(4)), 2, 30, seed=0)
    means = sorted(got.means[:, 0].tolist())
    assert abs(means[0]) < 0.3 and abs(means[1] - 4.0) < 0.3
    np.testing.assert_allclose(sorted(got.weights.tolist()), [0.4, 0.6], atol=0.03)


def test_init_indices_are_distinct_seeded_and_in_range():
    a = tg._init_indices(4096, 5, 3)
    assert a.dtype == torch.int64 and len(set(a.tolist())) == 5
    assert int(a.min()) >= 0 and int(a.max()) < 4096
    assert torch.equal(a, tg._init_indices(4096, 5, 3))
    assert not torch.equal(a, tg._init_indices(4096, 5, 4))


def _segment_case(seed=0):
    """(16, 16, 24, 2) features, two regions; class 0 seeds 3000 voxels of
    the first (fewer than 4096, so its fit takes unseeded voxels too), class
    1 seeds 500 of the second."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.0, 1.0, (16, 16, 24, 2)).astype(np.float32)
    vol[8:] = rng.normal(3.0, 0.6, (8, 16, 24, 2))
    seeds = -np.ones((16, 16, 24), np.int32)
    flat = seeds.reshape(-1)
    first = np.flatnonzero(np.arange(flat.size) < 8 * 16 * 24)
    second = np.flatnonzero(np.arange(flat.size) >= 8 * 16 * 24)
    flat[rng.choice(first, 3000, replace=False)] = 0
    flat[rng.choice(second, 500, replace=False)] = 1
    return vol, seeds


def test_gmm_segment_matches_jax(jax_init):
    vol, seeds = _segment_case()
    want = np.asarray(jg.gmm_segment(jnp.asarray(vol), jnp.asarray(seeds)))
    got = tg.gmm_segment(torch.from_numpy(vol), torch.from_numpy(seeds))
    assert got.shape == seeds.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < float(got.float().mean()) < 0.8


def test_gmm_segment_fits_each_class_on_a_stable_argsort(monkeypatch):
    """Class c is fitted (seed c) on the first 4096 rows of a stable
    argsort of "not seeded c": its seeds in voxel order, then unseeded
    voxels (and the other class's seeds) in voxel order."""
    vol, seeds = _segment_case(1)
    feats = vol.reshape(-1, 2)
    calls = []
    fit = tg.gmm_fit

    def recording_fit(x, k, n_iters, seed):
        calls.append((x.clone(), k, n_iters, seed))
        return fit(x, k, n_iters, seed=seed)

    monkeypatch.setattr(tg, "gmm_fit", recording_fit)
    tg.gmm_segment(torch.from_numpy(vol), torch.from_numpy(seeds), n_iters=1)
    assert [c[1:] for c in calls] == [(2, 1, 0), (2, 1, 1)]
    for cls, (x, *_) in enumerate(calls):
        order = np.argsort(seeds.reshape(-1) != cls, kind="stable")[:4096]
        np.testing.assert_array_equal(x.numpy(), feats[order])
