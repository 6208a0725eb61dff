"""The port's Haar `dwt3`/`idwt3` are bit-equal to the JAX ops (CPU).

Both layouts take the JAX package's own path: channels-last 5-D input at
`axes=(1, 2, 3)` the phase path (butterflies over W, H, D after one
reshape-transpose), NCDHW at `axes=(2, 3, 4)` the per-axis cascade. Each
multiplies by 1/√2 rounded to the input's dtype. The same seeded numpy
input goes to both sides (bf16 rounded once from fp32 on each), and every
output must be `torch.equal`: no tolerance.
"""

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
