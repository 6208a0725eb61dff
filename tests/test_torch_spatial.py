"""The port's grid pull/push, count and spline prefilter against the JAX
package (CPU).

Seeded numpy volumes and coordinates go through `waveformer_tpu.ops.spatial`
and `waveformer_tpu_torch.ops.spatial`. The coordinates reach past every
face (negative ones included) and hold exact halves, so every bound mode,
the floor-modulo of `reflect` and the round-half-up of orders 0 and 2 are
exercised. Tolerances: pull, push and count 1e-5 relative to the largest
output (the same fp32 products and sums in the same order, so in practice
equal); gradients 1e-4 relative; the prefilter 1e-5 relative (a recursion
of ~130 fp32 steps per axis).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.ops import spatial as js
from waveformer_tpu_torch.ops import spatial as ts

SHAPE = (6, 7, 5)
C = 3
N = 160
BOUNDS = ("zero", "clamp", "reflect")


def _volume(seed=0, shape=SHAPE, c=C):
    return np.random.default_rng(seed).standard_normal((*shape, c)).astype(np.float32)


def _coords(seed=1, shape=SHAPE, n=N):
    """Uniform over [−3, extent + 2] per axis, plus exact halves and exact
    integers (some negative)."""
    rng = np.random.default_rng(seed)
    hi = np.array(shape, np.float32) + 2.0
    crd = rng.uniform(-3.0, 1.0, (n, 3)).astype(np.float32) * (hi + 3.0) / 4.0
    crd[: n // 8] = np.floor(crd[: n // 8]) + 0.5
    crd[n // 8: n // 4] = np.floor(crd[n // 8: n // 4])
    return crd


def _close(got, want, rtol):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("bound", BOUNDS)
@pytest.mark.parametrize("order", range(4))
def test_grid_pull_matches_jax(order, bound):
    vol, crd = _volume(), _coords()
    want = js.grid_pull(jnp.asarray(vol), jnp.asarray(crd), bound, order)
    got = ts.grid_pull(torch.from_numpy(vol), torch.from_numpy(crd), bound, order)
    _close(got, want, 1e-5)


def test_grid_pull_per_dim_orders_and_bounds():
    vol, crd = _volume(2), _coords(3)
    bound, order = ("reflect", "zero", "clamp"), (3, 0, 2)
    want = js.grid_pull(jnp.asarray(vol), jnp.asarray(crd), bound, order)
    got = ts.grid_pull(torch.from_numpy(vol), torch.from_numpy(crd), bound, order)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("order", range(4))
def test_grid_push_and_count_match_jax(order):
    vals, crd = _volume(4, (N,), C).reshape(N, C), _coords(5)
    bound = ("zero", "reflect", "clamp")
    want = js.grid_push(jnp.asarray(vals), jnp.asarray(crd), SHAPE, bound, order)
    got = ts.grid_push(torch.from_numpy(vals), torch.from_numpy(crd), SHAPE, bound, order)
    _close(got, want, 1e-5)
    want = js.grid_count(jnp.asarray(crd), SHAPE, bound, order)
    got = ts.grid_count(torch.from_numpy(crd), SHAPE, bound, order)
    assert got.shape == SHAPE and got.dtype == torch.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("order,bound", [(1, "zero"), (3, "reflect")])
def test_grid_pull_gradients_match_jax_custom_vjp(order, bound):
    """The volume's gradient (a push of the cotangent) and the coordinates'
    (the derivative of the weights) against `jax.grad` through JAX's
    `custom_vjp`."""
    vol, crd = _volume(6), _coords(7)
    g = np.random.default_rng(8).standard_normal((N, C)).astype(np.float32)

    def loss(v, c):
        return jnp.sum(js.grid_pull(v, c, bound, order) * g)

    jv, jc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(crd))
    v = torch.from_numpy(vol).requires_grad_(True)
    c = torch.from_numpy(crd).requires_grad_(True)
    (ts.grid_pull(v, c, bound, order) * torch.from_numpy(g)).sum().backward()
    _close(v.grad, jv, 1e-4)
    _close(c.grad, jc, 1e-4)


def test_reflect_is_a_floor_modulo_on_negative_coordinates():
    """`reflect` maps −3 to 3 on an axis of 5 (period 8): a floor-modulo.
    `fmod` keeps −3, which would index from the far end."""
    idx = torch.tensor([-9, -8, -7, -3, -1, 0, 4, 5, 7, 8, 12], dtype=torch.int32)
    got, mask = ts._apply_bound(idx, 5, "reflect")
    want, _ = js._apply_bound(jnp.asarray(idx.numpy()), 5, "reflect")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1, 0, 1, 3, 1, 0, 4, 3, 1, 0, 4]
    assert bool((mask == 1).all())
    vol = _volume(9, (5, 5, 5), 1)
    crd = np.array([[-3.0, -3.0, -3.0], [-7.25, 2.0, -1.5]], np.float32)
    for order in (0, 1):
        want = js.grid_pull(jnp.asarray(vol), jnp.asarray(crd), "reflect", order)
        _close(ts.grid_pull(torch.from_numpy(vol), torch.from_numpy(crd), "reflect", order),
               want, 1e-6)


def test_zero_bound_clips_the_index_and_masks_the_weight():
    idx = torch.tensor([-2, -1, 0, 3, 4, 5], dtype=torch.int32)
    got, mask = ts._apply_bound(idx, 4, "zero")
    assert got.tolist() == [0, 0, 0, 3, 3, 3]
    assert mask.dtype == torch.float32 and mask.tolist() == [0, 0, 1, 1, 0, 0]


@pytest.mark.parametrize("order", [0, 2])
def test_orders_0_and_2_round_halves_up(order):
    """floor(x + 0.5): 2.5 → 3 and −0.5 → 0, where `torch.round` gives 2
    and −0."""
    x = torch.tensor([2.5, -0.5, 1.5, 0.49, 3.5])
    got = ts._spline_taps(x, order)
    want = js._spline_taps(jnp.asarray(x.numpy()), order)
    for (gi, gw), (wi, ww) in zip(got, want):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=1e-6)
    centre = got[0][0] if order == 0 else got[1][0]
    assert centre.tolist() == [3, 0, 2, 0, 4]


def test_output_dtypes():
    """Pull returns the volume's dtype (fp32 sums); push and count return
    fp32 whatever the values' dtype; the volume's gradient takes the
    volume's dtype."""
    vol, crd = _volume(10), _coords(11)
    vb = torch.from_numpy(vol).to(torch.bfloat16)
    out = ts.grid_pull(vb, torch.from_numpy(crd), "clamp", 3)
    want = js.grid_pull(jnp.asarray(vol).astype(jnp.bfloat16), jnp.asarray(crd), "clamp", 3)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(want.astype(jnp.float32)))
    vals = torch.from_numpy(_volume(12, (N,), C).reshape(N, C)).to(torch.bfloat16)
    assert ts.grid_push(vals, torch.from_numpy(crd), SHAPE).dtype == torch.float32
    assert ts.grid_count(torch.from_numpy(crd), SHAPE).dtype == torch.float32
    vb.requires_grad_(True)
    ts.grid_pull(vb, torch.from_numpy(crd), "zero", 1).float().sum().backward()
    assert vb.grad.dtype == torch.bfloat16


def test_push_is_the_adjoint_of_pull():
    """<pull(v), u> = <v, push(u)> at every order, mixed bounds."""
    vol, crd = _volume(13), _coords(14)
    u = _volume(15, (N,), C).reshape(N, C)
    for order in range(4):
        bound = ("reflect", "zero", "clamp")
        lhs = float((ts.grid_pull(torch.from_numpy(vol), torch.from_numpy(crd), bound, order)
                     .double() * torch.from_numpy(u).double()).sum())
        rhs = float((torch.from_numpy(vol).double() * ts.grid_push(
            torch.from_numpy(u), torch.from_numpy(crd), SHAPE, bound, order).double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("order", [2, 3, (3, 0, 2)])
def test_spline_prefilter_matches_jax(order):
    """Axis 0 is longer than the causal start's 53 terms at order 3."""
    vol = _volume(16, (64, 5, 6), 2)
    want = js.spline_prefilter(jnp.asarray(vol), order)
    got = ts.spline_prefilter(torch.from_numpy(vol), order)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_spline_prefilter_ignores_bound_and_keeps_dtype():
    vol = torch.from_numpy(_volume(17, (7, 6, 5), 1))
    ref = ts.spline_prefilter(vol, 3)
    for bound in ("zero", "clamp", ("zero", "reflect", "clamp")):
        assert torch.equal(ts.spline_prefilter(vol, 3, bound), ref)
    out = ts.spline_prefilter(vol.to(torch.bfloat16), 3)
    assert out.dtype == torch.bfloat16


def test_prefilter_causal_start_horizon():
    """min(n, ceil(−30 / log10|z|)) terms: 53 at order 3, 40 at order 2."""
    for z in (3.0 ** 0.5 - 2.0, 2.0 ** 0.5 * 2.0 - 3.0):
        want = int(jnp.ceil(-30.0 / jnp.log10(abs(z))))
        assert ts._horizon(1000, z) == want
        assert ts._horizon(7, z) == 7
    assert ts._horizon(1000, 3.0 ** 0.5 - 2.0) == 53
    assert ts._horizon(1000, 2.0 ** 0.5 * 2.0 - 3.0) == 40


def test_prefiltered_pull_interpolates():
    """Pull at integer coordinates of the prefiltered volume returns the
    samples, at the JAX package's own test's extents and limit (5e-4: the
    causal start's sum stops after n terms, short of the mirror's period)."""
    vol = _volume(18, (12, 11, 13), 2)
    coeffs = ts.spline_prefilter(torch.from_numpy(vol), 3)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in vol.shape[:3]], indexing="ij"), -1)
    crd = torch.from_numpy(grid.reshape(-1, 3).astype(np.float32))
    got = ts.grid_pull(coeffs, crd, "reflect", 3).reshape(vol.shape)
    np.testing.assert_allclose(got.numpy(), vol, atol=5e-4)


def test_bad_arguments_raise():
    vol, crd = torch.zeros(3, 3, 3, 1), torch.zeros(2, 3)
    with pytest.raises(ValueError):
        ts.grid_pull(vol, crd, "wrap", 1)
    with pytest.raises(ValueError):
        ts.grid_pull(vol, crd, "zero", 4)
    with pytest.raises(ValueError):
        ts.grid_push(crd[:, :1], crd, (3, 3, 3), ("zero", "zero"), 1)
