"""The port's criss-cross attention against the JAX package (CPU).

Tolerances: the forward 1e-5 relative to the largest output, the gradients
of q, k and v 1e-4 relative (einsums summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.ops import cc_attention as jc
from waveformer_tpu_torch.ops import cc_attention as tc


def _qkv(b, h, w, cqk, cv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, cqk)).astype(np.float32),
            rng.standard_normal((b, h, w, cqk)).astype(np.float32),
            rng.standard_normal((b, h, w, cv)).astype(np.float32))


def _close(got, want, rtol):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * float(np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 6, 7, 4, 5), (1, 9, 5, 8, 3), (1, 1, 4, 2, 2)])
def test_criss_cross_attention_matches_jax(shape):
    q, k, v = _qkv(*shape)
    want = jc.criss_cross_attention(*map(jnp.asarray, (q, k, v)))
    got = tc.criss_cross_attention(*map(torch.from_numpy, (q, k, v)))
    _close(got, want, 1e-5)


def test_criss_cross_gradients_match_jax():
    q, k, v = _qkv(2, 5, 6, 4, 3, seed=1)
    g = np.random.default_rng(2).standard_normal((2, 5, 6, 3)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jc.criss_cross_attention(*a) * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (tc.criss_cross_attention(*leaves) * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves, want):
        _close(t.grad, w, 1e-4)


def test_scale_and_self_position_counted_once():
    """Written out for one position: logits q·k·Cqk^-0.5 over its row (W
    keys, itself included) and its column without itself (H − 1 keys)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 5, 3, 2, seed=3))
    i, j = 2, 1
    keys = torch.cat([k[0, i], torch.cat([k[0, :i, j], k[0, i + 1:, j]])])
    vals = torch.cat([v[0, i], torch.cat([v[0, :i, j], v[0, i + 1:, j]])])
    attn = torch.softmax(keys @ q[0, i, j] * 3 ** -0.5, dim=0)
    want = attn @ vals
    got = tc.criss_cross_attention(q, k, v)[0, i, j]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
