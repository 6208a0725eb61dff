"""The port's Haar `dwt3`/`idwt3` are bit-equal to the JAX ops (CPU).

Both layouts take the JAX package's own path: channels-last 5-D input at
`axes=(1, 2, 3)` the phase path (butterflies over W, H, D after one
reshape-transpose), NCDHW at `axes=(2, 3, 4)` the per-axis cascade. Each
multiplies by 1/√2 rounded to the input's dtype. The same seeded numpy
input goes to both sides (bf16 rounded once from fp32 on each), and every
output must be `torch.equal`: no tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.ops import wavelet as jwv
from waveformer_tpu_torch.ops import wavelet as twv

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# (B, D, H, W, C): an even volume and one with odd D, H and W
SHAPES = [(2, 8, 6, 4, 5), (1, 7, 9, 5, 3)]
LAYOUTS = {"channels_last": (1, 2, 3), "ncdhw": (2, 3, 4)}


def _pair(shape, dtype, layout, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if layout == "ncdhw":
        x = np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _assert_equal(t, j):
    assert t.dtype == {jnp.float32: torch.float32,
                       jnp.bfloat16: torch.bfloat16}[j.dtype.type]
    want = torch.from_numpy(np.array(j.astype(jnp.float32)))
    assert t.shape == want.shape
    assert torch.equal(t.float(), want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dwt3_bit_equal_to_jax(dtype, shape, layout):
    axes = LAYOUTS[layout]
    tx, jx = _pair(shape, dtype, layout, seed=0)
    tl, td = twv.dwt3(tx, axes=axes)
    jl, jd = jwv.dwt3(jx, axes=axes)
    _assert_equal(tl, jl)
    assert tuple(td) == tuple(jd) == twv.DETAIL_KEYS
    for k in twv.DETAIL_KEYS:
        _assert_equal(td[k], jd[k])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_idwt3_bit_equal_to_jax(dtype, shape, layout):
    """Eight independent seeded subbands of the halved (rounded up) extents."""
    axes = LAYOUTS[layout]
    b, d, h, w, c = shape
    half = (b, (d + 1) // 2, (h + 1) // 2, (w + 1) // 2, c)
    subs = [_pair(half, dtype, layout, seed=1 + i) for i in range(8)]
    tl, jl = subs[0]
    td = {k: t for k, (t, _) in zip(twv.DETAIL_KEYS, subs[1:])}
    jd = {k: j for k, (_, j) in zip(twv.DETAIL_KEYS, subs[1:])}
    _assert_equal(twv.idwt3(tl, td, axes=axes), jwv.idwt3(jl, jd, axes=axes))


# --------------------------------------------------------------------------- #
# the generic FIR path (registered wavelets other than db1/haar)
# --------------------------------------------------------------------------- #

# banks registered in both packages under the tests' own names, removed again
# after each test (both registries are module state)
_SQ = 1.0 / np.sqrt(2.0)
BANKS = {
    # a 2-tap orthonormal bank whose taps are not 1/√2
    "test_rot2": ([0.6, 0.8], [-0.8, 0.6], [0.8, 0.6], [0.6, -0.8]),
    # db1's bank under another name: the generic path, not the Haar one
    "test_db1_copy": ([_SQ, _SQ], [-_SQ, _SQ], [_SQ, _SQ], [_SQ, -_SQ]),
    # db2's 4 taps: the JAX analysis fails at every extent
    "test_db2": ([-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
                  0.48296291314469025],
                 [-0.48296291314469025, 0.836516303737469, -0.22414386804185735,
                  -0.12940952255092145],
                 [0.48296291314469025, 0.836516303737469, 0.22414386804185735,
                  -0.12940952255092145],
                 [-0.12940952255092145, -0.22414386804185735, 0.836516303737469,
                  -0.48296291314469025]),
    # 3 taps: the JAX analysis works at odd extents only
    "test_tap3": ([0.25, 0.5, 0.25], [-0.25, 0.5, -0.25], [0.25, 0.5, 0.25],
                  [0.25, -0.5, 0.25]),
}


@pytest.fixture
def banks():
    for name, bank in BANKS.items():
        jwv.register_wavelet(name, *bank)
        twv.register_wavelet(name, *bank)
    yield BANKS
    for name in BANKS:
        jwv._WAVELETS.pop(name, None)
        twv._WAVELETS.pop(name, None)


def _close_rel(t, j, rtol=1e-6):
    want = np.array(j.astype(jnp.float32))
    got = t.float().numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_generic_2tap_dwt3_idwt3_match_jax(banks, dtype, shape):
    """Values within 1e-6 of the largest (fp32) and equal in bf16, where
    both sides correlate two bf16 products in fp32 and round once; the
    filters are cast to the input's dtype first (0.6 and 0.8 are not bf16
    values), as JAX casts them."""
    tx, jx = _pair(shape, dtype, "channels_last", seed=3)
    tl, td = twv.dwt3(tx, "test_rot2")
    jl, jd = jwv.dwt3(jx, "test_rot2")
    for t, j in [(tl, jl)] + [(td[k], jd[k]) for k in twv.DETAIL_KEYS]:
        assert t.dtype == tx.dtype
        if dtype == "bf16":
            _assert_equal(t, j)
        else:
            _close_rel(t, j)
    ty = twv.idwt3(tl, td, "test_rot2")
    jy = jwv.idwt3(jl, jd, "test_rot2")
    # the generic synthesis keeps 2n per axis (pywt's length would be 2n − L + 2)
    assert tuple(ty.shape) == tuple(jy.shape) == (
        shape[0], *(2 * ((s + 1) // 2) for s in shape[1:4]), shape[4])
    if dtype == "bf16":
        _assert_equal(ty, jy)
    else:
        _close_rel(ty, jy)


def test_generic_filters_take_the_inputs_dtype(banks):
    """bf16 input: the bank is rounded to bf16 before the product. With the
    fp32 taps 0.6/0.8 instead, the bf16 outputs would differ from JAX's."""
    tx, jx = _pair((1, 4, 4, 4, 2), "bf16", "channels_last", seed=4)
    tl, _ = twv.dwt3(tx, "test_rot2")
    jl, _ = jwv.dwt3(jx, "test_rot2")
    _assert_equal(tl, jl)
    k = twv._filter(twv._WAVELETS["test_rot2"][0], tx)
    assert k.dtype == torch.bfloat16 and k.flatten().tolist() == [0.80078125, 0.6015625]


@pytest.mark.parametrize("shape,level", [((1, 16, 8, 12, 3), 2), ((2, 7, 9, 5, 2), 2),
                                         ((1, 8, 8, 8, 4), 3)])
def test_generic_wavedec_waverec_match_jax(banks, shape, level):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    # the JAX side under jit: eager, each of its convs compiles on its own
    jc = jax.jit(functools.partial(jwv.wavedec3, wavelet="test_rot2", level=level))(
        jnp.asarray(x))
    tc = twv.wavedec3(torch.from_numpy(x), "test_rot2", level=level)
    _close_rel(tc[0], jc[0])
    for jd, td in zip(jc[1:], tc[1:]):
        for k in twv.DETAIL_KEYS:
            _close_rel(td[k], jd[k])
    ty = twv.waverec3(tc, "test_rot2")
    _close_rel(ty, jax.jit(functools.partial(jwv.waverec3, wavelet="test_rot2"))(jc))
    # an orthonormal bank: the cascade is a perfect reconstruction where
    # no level was padded
    if all(s % 2 ** level == 0 for s in shape[1:4]):
        np.testing.assert_allclose(ty.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_generic_db1_copy_matches_the_haar_path(banks, shape):
    """db1's bank through the generic path (a conv) against the Haar
    cascade: the same values up to fp32 rounding."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(shape).astype(np.float32))
    gl, gd = twv.dwt3(x, "test_db1_copy")
    hl, hd = twv.dwt3(x, "db1")
    torch.testing.assert_close(gl, hl, rtol=0, atol=1e-6)
    for k in twv.DETAIL_KEYS:
        torch.testing.assert_close(gd[k], hd[k], rtol=0, atol=1e-6)
    torch.testing.assert_close(twv.idwt3(gl, gd, "test_db1_copy"), twv.idwt3(hl, hd), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 8, 8, 8, 1), (1, 7, 9, 5, 1)])
def test_generic_4tap_bank_raises_as_jax_fails(banks, shape):
    """JAX's analysis keeps (N + 3) // 2 samples of a conv that gives
    (N − 1) // 2 + 1 and fails in a reshape; the port raises ValueError
    before any work."""
    with pytest.raises(TypeError):
        jwv.dwt3(jnp.zeros(shape), "test_db2")
    with pytest.raises(ValueError, match="at most 2"):
        twv.dwt3(torch.zeros(shape), "test_db2")
    with pytest.raises(ValueError, match="at most 2"):
        twv.wavedec3(torch.zeros(shape), "test_db2", level=1)


def test_generic_3tap_bank_follows_jax_by_extent(banks):
    """3 taps: JAX computes at odd extents (the port matches it) and fails
    at an even one (the port raises)."""
    tx, jx = _pair((1, 7, 5, 9, 2), "fp32", "channels_last", seed=7)
    tl, td = twv.dwt3(tx, "test_tap3")
    jl, jd = jwv.dwt3(jx, "test_tap3")
    _close_rel(tl, jl)
    for k in twv.DETAIL_KEYS:
        _close_rel(td[k], jd[k])
    _close_rel(twv.idwt3(tl, td, "test_tap3"), jwv.idwt3(jl, jd, "test_tap3"))
    with pytest.raises(TypeError):
        jwv.dwt3(jnp.zeros((1, 7, 6, 9, 1)), "test_tap3")
    with pytest.raises(ValueError, match="3 at an odd extent"):
        twv.dwt3(torch.zeros(1, 7, 6, 9, 1), "test_tap3")


def test_unregistered_wavelet_raises():
    for fn in (lambda: twv.dwt3(torch.zeros(1, 4, 4, 4, 1), "test_unknown"),
               lambda: twv.idwt3(torch.zeros(1, 2, 2, 2, 1),
                                 {k: torch.zeros(1, 2, 2, 2, 1) for k in twv.DETAIL_KEYS},
                                 "test_unknown")):
        with pytest.raises(ValueError, match="register it first"):
            fn()
    with pytest.raises(ValueError, match="register it first"):
        jwv.dwt3(jnp.zeros((1, 4, 4, 4, 1)), "test_unknown")


def test_registry_holds_db1_and_haar():
    assert twv._WAVELETS["haar"] is twv._WAVELETS["db1"]
    for a, b in zip(twv._WAVELETS["db1"], jwv._WAVELETS["db1"]):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
