"""The TMA conv kernel's per-tap weight packing against the JAX kernels' K order.

`ops/conv_cuda.py::pack_taps` lays the (3, 3, 3, C, O) weights out as
(ceil(C / 16), 3, 9, O, 16) for `csrc/conv3.cu`'s TMA + wgmma design: one
(O × 16-channel) box per (chunk, kd, kh·3 + kw), channels past C zero. With
that padding removed it must give exactly the K order (kd, kh, kw, c) of the
JAX kernels' weight matrices: `w.transpose(4, 0, 1, 2, 3).reshape(O, 27·C)`
for the (D, H, C, W) kernel (`waveformer_tpu/ops/conv_pallas.py:170`) and
`w.reshape(27·C, O)` for the channels-last one (`:64`). C = 3, 4 and 6 put
a chunk across a tap's end: a box there must read zeros, not the next tap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu_torch.ops import conv_cuda as tcc

CASES = [(3, 5), (4, 48), (6, 8), (16, 48), (20, 96), (48, 48), (96, 192)]


def _weights(c, o, seed=0):
    return np.random.default_rng(seed).standard_normal((3, 3, 3, c, o)).astype(np.float32)


def _unpad(packed, c):
    """(chunks, 3, 9, O, 16) → (O, 27·C), K ordered (kd, kh, kw, c)."""
    chunks, _, _, o, _ = packed.shape
    return packed.permute(3, 1, 2, 0, 4).reshape(o, 27, chunks * 16)[:, :, :c].reshape(o, 27 * c)


@pytest.mark.parametrize("c,o", CASES)
def test_unpadded_pack_is_the_dhcw_k_order(c, o):
    w = _weights(c, o)
    want = np.asarray(jnp.asarray(w).transpose(4, 0, 1, 2, 3).reshape(o, 27 * c))
    got = _unpad(tcc.pack_taps(torch.from_numpy(w)), c)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,o", CASES)
def test_unpadded_pack_is_the_dhwc_k_order(c, o):
    w = _weights(c, o, seed=1)
    want = np.asarray(jnp.asarray(w).reshape(27 * c, o))
    got = _unpad(tcc.pack_taps(torch.from_numpy(w)), c)
    np.testing.assert_array_equal(got.t().numpy(), want)


@pytest.mark.parametrize("c,o", CASES)
def test_pack_layout_and_zero_padding(c, o):
    w = torch.from_numpy(_weights(c, o, seed=2)).to(torch.bfloat16)
    packed = tcc.pack_taps(w)
    chunks = -(-c // 16)
    assert packed.shape == (chunks, 3, 9, o, 16) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous()
    # element [chunk, kd, kh·3 + kw, n, i] is w[kd, kh, kw, 16·chunk + i, n]
    for chunk in range(chunks):
        for kd, kh, kw in ((0, 0, 0), (1, 2, 0), (2, 1, 2)):
            lo, hi = 16 * chunk, min(16 * chunk + 16, c)
            box = packed[chunk, kd, kh * 3 + kw]
            assert torch.equal(box[:, : hi - lo], w[kd, kh, kw, lo:hi].t())
            # channels past C: a 16-channel box reads zeros, never the next tap
            assert not box[:, hi - lo:].any()
