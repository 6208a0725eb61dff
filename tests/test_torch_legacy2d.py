"""The port's legacy 2D modules against the JAX package's (CPU).

Each flax module is initialised from a PRNG key, its params carried into
the port module by `legacy2d_state_dict_from_jax`, and both run the same
seeded input. Tolerance 1e-5 relative to the largest output: the port's
GELU is the exact erf, JAX's a polynomial within 1.5e-7 of it, and the
convs sum in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.models import legacy2d as jl
from waveformer_tpu_torch.models import legacy2d as tl
from waveformer_tpu_torch.utils.jax_params import legacy2d_state_dict_from_jax


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * float(np.abs(want).max())


def _carry(jmod, tmod, *args, seed=0):
    params = jmod.init(jax.random.PRNGKey(seed), *args)
    tmod.load_state_dict(legacy2d_state_dict_from_jax(jax.tree.map(np.asarray, params)),
                         strict=True)
    return params, tmod.eval()


@pytest.mark.parametrize("hidden,out", [(None, None), (32, 8)])
def test_mlp2d_matches_jax(hidden, out):
    # Dense weights scaled up so that the GELU sees more than its linear part
    x = _rand((2, 12, 16), 1, scale=20.0)
    jmod = jl.Mlp2D(hidden_features=hidden, out_features=out)
    params, tmod = _carry(jmod, tl.Mlp2D(16, hidden, out), jnp.asarray(x))
    _close(tmod(torch.from_numpy(x)), jmod.apply(params, jnp.asarray(x)))


def test_dwconv2d_matches_jax():
    b, h, w, c = 2, 6, 5, 8
    x = _rand((b, h * w, c), 2)
    jmod = jl.DWConv2D()
    params, tmod = _carry(jmod, tl.DWConv2D(c), jnp.asarray(x), h, w)
    _close(tmod(torch.from_numpy(x), h, w), jmod.apply(params, jnp.asarray(x), h, w))


@pytest.mark.parametrize("patch,stride,hw", [(7, 4, (19, 16)), (3, 2, (9, 8))])
def test_overlap_patch_embed_matches_jax(patch, stride, hw):
    x = _rand((2, *hw, 3), 3)
    jmod = jl.OverlapPatchEmbed2D(embed_dim=16, patch_size=patch, stride=stride)
    params, tmod = _carry(jmod, tl.OverlapPatchEmbed2D(3, 16, patch, stride), jnp.asarray(x))
    jt, jh, jw = jmod.apply(params, jnp.asarray(x))
    tt, th, tw = tmod(torch.from_numpy(x))
    assert (th, tw) == (jh, jw) and isinstance(th, int)
    _close(tt, jt)


def test_overlap_patch_embed_layernorm_eps_is_1e_5():
    """Tokens of variance ~1e-6, where LayerNorm's eps 1e-5 and flax's
    default 1e-6 give different outputs: the port keeps JAX's 1e-5."""
    x = _rand((1, 8, 8, 2), 4, scale=1e-3)
    jmod = jl.OverlapPatchEmbed2D(embed_dim=8, patch_size=3, stride=2)
    params, tmod = _carry(jmod, tl.OverlapPatchEmbed2D(2, 8, 3, 2), jnp.asarray(x))
    assert tmod.norm.eps == 1e-5
    _close(tmod(torch.from_numpy(x))[0], jmod.apply(params, jnp.asarray(x))[0])


@pytest.mark.parametrize("stride", [1, 2])
def test_poscnn2d_matches_jax(stride):
    """The residual is added at stride 1 only."""
    b, h, w, c = 2, 6, 8, 16
    x = _rand((b, h * w, c), 5)
    jmod = jl.PosCNN2D(embed_dim=c, stride=stride)
    params, tmod = _carry(jmod, tl.PosCNN2D(c, stride), jnp.asarray(x), h, w)
    want = jmod.apply(params, jnp.asarray(x), h, w)
    got = tmod(torch.from_numpy(x), h, w)
    _close(got, want)
    if stride == 2:
        assert got.shape == (b, (h // 2) * (w // 2), c)
    else:
        tmod.proj_pw.weight.data.zero_()
        tmod.proj_pw.bias.data.zero_()
        assert torch.equal(tmod(torch.from_numpy(x), h, w), torch.from_numpy(x))


def test_poscnn2d_requires_in_equal_embed():
    x = jnp.zeros((1, 16, 8))
    with pytest.raises(ValueError, match="in_chans == embed_dim"):
        jl.PosCNN2D(embed_dim=12).init(jax.random.PRNGKey(0), x, 4, 4)
    with pytest.raises(ValueError, match="in_chans == embed_dim"):
        tl.PosCNN2D(12)(torch.zeros(1, 16, 8), 4, 4)


def test_token_count_must_match_the_grid():
    with pytest.raises(ValueError, match="token count"):
        tl.DWConv2D(4)(torch.zeros(1, 10, 4), 3, 3)


def test_dropout_follows_train_and_eval():
    m = tl.Mlp2D(8, 16, dropout_rate=0.5, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 10, 8)
    assert torch.equal(m.eval()(x), m(x))
    torch.manual_seed(0)
    assert not torch.equal(m.train()(x), m.eval()(x))


def test_inits_follow_jax_and_the_generator():
    """Dense: trunc-normal std 0.02 within ±2σ; convs: normal(0, √(2 /
    (kh·kw·out))); biases 0; one generator seed gives one set of weights."""
    g = torch.Generator().manual_seed(0)
    m = tl.Mlp2D(256, 1024, generator=g)
    w = m.fc1.weight.detach()
    assert float(w.abs().max()) <= 0.04 and abs(float(w.std()) - 0.0176) < 1e-3
    assert not m.fc1.bias.any() and not m.fc2.bias.any()
    p = tl.PosCNN2D(64, generator=torch.Generator().manual_seed(1))
    for conv, fan_out in ((p.proj_dw, 9 * 64), (p.proj_pw, 64)):
        assert abs(float(conv.weight.detach().std()) / (2.0 / fan_out) ** 0.5 - 1) < 0.1
        assert not conv.bias.any()
    e = tl.OverlapPatchEmbed2D(3, 64, generator=torch.Generator().manual_seed(2))
    assert abs(float(e.proj.weight.detach().std()) / (2.0 / (49 * 64)) ** 0.5 - 1) < 0.05
    again = tl.Mlp2D(256, 1024, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.fc1.weight, w) and torch.equal(again.fc2.weight, m.fc2.weight)
