"""The port's bilateral filters against the JAX package (CPU).

Seeded numpy volumes (B, D, H, W, C) go through `waveformer_tpu.ops.bilateral`
and `waveformer_tpu_torch.ops.bilateral`. Tolerances: forwards 1e-5
relative to the largest output (the same fp32 terms summed over the offsets
in the same order); gradients in x and both sigmas 1e-4 relative. Most
cases use radius 1 (27 offsets) and one shape, so that JAX's eager ops,
compiled once per shape, stay few.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.ops import bilateral as jb
from waveformer_tpu_torch.ops import bilateral as tb
from waveformer_tpu_torch.utils.jax_params import bilateral_state_dict_from_jax


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * max(float(np.abs(want).max()), 1e-30)


SHAPE = (1, 4, 5, 3, 2)


@pytest.mark.parametrize("shape,ss,cs,kw", [
    ((1, 6, 7, 5, 2), 1.0, 0.5, {}),  # radius 2: 125 offsets
    (SHAPE, 0.3, 1.5, {"truncate": 3.0}),
    (SHAPE, 2.0, 0.8, {"radius": 1}),
])
def test_bilateral_filter_matches_jax(shape, ss, cs, kw):
    x = _rand(shape, 0)
    want = jb.bilateral_filter(jnp.asarray(x), ss, cs, **kw)
    got = tb.bilateral_filter(torch.from_numpy(x), ss, cs, **kw)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_bilateral_filter_bf16_keeps_dtype():
    x = _rand(SHAPE, 1)
    want = jb.bilateral_filter(jnp.asarray(x).astype(jnp.bfloat16), 0.5, 0.7)
    got = tb.bilateral_filter(torch.from_numpy(x).to(torch.bfloat16), 0.5, 0.7)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)


def test_zero_filled_neighbours_weigh_in_the_denominator():
    """A constant volume of ones: at a corner, the neighbours shifted in
    from outside are zeros whose weights G_s(o)·exp(−1/2σc²) still add to
    the denominator, so the output there is below 1; inside it is 1."""
    x = np.ones((1, 5, 5, 5, 1), np.float32)
    ss, cs = 1.0, 0.5
    got = tb.bilateral_filter(torch.from_numpy(x), ss, cs).numpy()
    inside = outside = 0.0
    for o in itertools.product(range(-2, 3), repeat=3):
        ws = np.exp(-sum(v * v for v in o) / (2 * ss ** 2))
        if all(0 <= v <= 4 for v in o):  # the corner (0, 0, 0) sees p + o inside
            inside += ws
        else:
            outside += ws * np.exp(-1.0 / (2 * cs ** 2))
    np.testing.assert_allclose(got[0, 0, 0, 0, 0], inside / (inside + outside), rtol=1e-5)
    np.testing.assert_allclose(got[0, 2, 2, 2, 0], 1.0, rtol=1e-6)


def test_shift_fills_zeros():
    x = torch.arange(1, 5, dtype=torch.float32).reshape(1, 4, 1, 1, 1)
    assert tb._shift(x, (1, 0, 0)).flatten().tolist() == [0, 1, 2, 3]
    assert tb._shift(x, (-2, 0, 0)).flatten().tolist() == [3, 4, 0, 0]
    y = _rand((2, 4, 5, 3, 2), 2)
    for off in [(1, -1, 2), (0, 0, -3), (-1, 2, 0)]:
        np.testing.assert_array_equal(tb._shift(torch.from_numpy(y), off).numpy(),
                                      np.asarray(jb._shift(jnp.asarray(y), off)))


def test_tensor_sigma_without_radius_raises():
    x = torch.zeros(1, 3, 3, 3, 1)
    with pytest.raises(ValueError, match="radius"):
        tb.bilateral_filter(x, torch.tensor(1.0), 0.5)
    with pytest.raises(ValueError, match="radius"):
        jb.bilateral_filter(jnp.zeros((1, 3, 3, 3, 1)), jnp.asarray(1.0), 0.5)


def test_bilateral_gradients_match_jax():
    """d/dx, d/dσs and d/dσc of Σ g·y, tensor sigmas at radius 1."""
    x = _rand(SHAPE, 3)
    g = _rand(SHAPE, 4)

    def loss(xx, ss, cs):
        return jnp.sum(jb.bilateral_filter(xx, ss, cs, radius=1) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.float32(0.7), jnp.float32(0.9))
    leaves = [torch.from_numpy(x), torch.tensor(0.7), torch.tensor(0.9)]
    for t in leaves:
        t.requires_grad_(True)
    (tb.bilateral_filter(*leaves, radius=1) * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves, want):
        _close(t.grad, w, 1e-4)


def test_joint_bilateral_filter_matches_jax():
    """The range distance sums over the guide's 3 channels and weighs both
    channels of x alike."""
    x, guide = _rand(SHAPE, 5), _rand((*SHAPE[:4], 3), 6)
    want = jb.joint_bilateral_filter(jnp.asarray(x), jnp.asarray(guide), 0.5, 0.7)
    got = tb.joint_bilateral_filter(torch.from_numpy(x), torch.from_numpy(guide), 0.5, 0.7)
    _close(got, want, 1e-5)


def test_joint_bilateral_gradients_match_jax():
    x, guide = _rand(SHAPE, 7), _rand((*SHAPE[:4], 3), 8)
    g = _rand(SHAPE, 9)

    def loss(xx, gg):
        return jnp.sum(jb.joint_bilateral_filter(xx, gg, 0.5, 0.8) * g)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(guide))
    leaves = [torch.from_numpy(x).requires_grad_(True),
              torch.from_numpy(guide).requires_grad_(True)]
    (tb.joint_bilateral_filter(*leaves, 0.5, 0.8) * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves, want):
        _close(t.grad, w, 1e-4)


@pytest.mark.parametrize("sigmas", [(0.5, 0.9), (-0.5, 1e-4)])
def test_trainable_filter_matches_jax_with_carried_params(sigmas):
    """Forward and the gradients of x and both sigmas, the JAX params
    carried by `bilateral_state_dict_from_jax`; at (−0.5, 1e-4) both sigmas
    are clamped at 1e-3 and their gradients are 0."""
    jmod = jb.TrainableBilateralFilter(spatial_sigma=0.5, color_sigma=0.9)
    params = {"spatial_sigma": jnp.float32(sigmas[0]), "color_sigma": jnp.float32(sigmas[1])}
    x, g = _rand(SHAPE, 10), _rand(SHAPE, 11)

    def loss(p, xx):
        return jnp.sum(jmod(p, xx) * g)

    jy = jmod(params, jnp.asarray(x))
    jp, jx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tmod = tb.TrainableBilateralFilter(spatial_sigma=0.5, color_sigma=0.9)
    assert tmod.radius == jmod.radius == 1
    tmod.load_state_dict(bilateral_state_dict_from_jax(
        {k: np.asarray(v) for k, v in params.items()}), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tmod(xt)
    _close(y, jy, 1e-5)
    (y * torch.from_numpy(g)).sum().backward()
    _close(xt.grad, jx, 1e-4)
    for name in ("spatial_sigma", "color_sigma"):
        got, want = getattr(tmod, name).grad, np.asarray(jp[name])
        if sigmas[0] < 0:
            assert float(got) == float(want) == 0.0
        else:
            _close(got, want, 1e-4)
