"""The depthwise 3³ stencil with its bias against the JAX package on the CPU.

The port's `dwconv3(x, k, bias)` adds the conv bias inside the kernel's
epilogue; the JAX model adds it right after the stencil
(`waveformer_tpu/models/common.py`). Here the JAX side is the Pallas kernel
in interpret mode plus the bias, the port's side its plain version (CPU
tensors), in fp32: sums of the same terms in another order (atol 1e-5).
Also the dispatch rule between the kernel's two designs, mirrored in
Python, and the argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.ops import dwconv_pallas as jdp
from waveformer_tpu_torch.ops import dwconv_cuda as tdc

SHAPES = [(1, 6, 5, 7, 96), (2, 4, 4, 4, 192), (1, 3, 3, 3, 8)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, shape[-1])).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, w, b


def _jax_conv_bias(x, w, b):
    return jdp.dwconv3(x, w, True) + b


@pytest.mark.parametrize("shape", SHAPES)
def test_bias_matches_jax(shape):
    x, w, b = _inputs(shape, 0)
    want = np.asarray(_jax_conv_bias(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    before = tdc.launches
    got = tdc.dwconv3(*map(torch.from_numpy, (x, w, b)))
    assert tdc.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    ref = tdc.dwconv3_reference(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(ref.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 3, 4, 4, 16), (1, 3, 3, 3, 8)])
def test_gradients_with_bias_match_jax(shape):
    x, w, b = _inputs(shape, 1)
    gj = jax.grad(lambda a, k, c: jnp.sum(_jax_conv_bias(a, k, c) ** 2), (0, 1, 2))(
        *map(jnp.asarray, (x, w, b)))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    (tdc.dwconv3(xt, wt, bt) ** 2).sum().backward()
    for got, want in zip((xt.grad, wt.grad, bt.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_bias_is_bit_equal_to_none(dtype):
    x, w, _ = _inputs((2, 4, 5, 6, 24), 2)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w)
    assert torch.equal(tdc.dwconv3(xt, wt), tdc.dwconv3(xt, wt, None))
    assert torch.equal(tdc.dwconv3(xt, wt), tdc.dwconv3_reference(xt, wt))


def test_bias_keeps_input_dtype():
    x, w, b = _inputs((1, 3, 3, 4, 16), 3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tdc.dwconv3(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    want = tdc.dwconv3_reference(xt, torch.from_numpy(w)) + torch.from_numpy(b).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,c,name", [
    (torch.bfloat16, 192, "tma_ring"), (torch.bfloat16, 96, "tma_ring"),
    (torch.bfloat16, 8, "tma_ring"), (torch.bfloat16, 1536, "tma_ring"),
    (torch.bfloat16, 20, "vector"), (torch.bfloat16, 4, "vector"),
    (torch.float32, 192, "vector"), (torch.float32, 20, "vector"),
])
def test_design_rule(dtype, c, name):
    assert tdc.design(dtype, c) == name
    assert set(tdc.design_launches) == set(tdc.DESIGNS) == {"vector", "tma_ring"}


@pytest.mark.parametrize("bias_shape", [(8,), (17,), (1, 16), (3, 3, 3, 16), ()])
def test_wrong_bias_shape_raises(bias_shape):
    x = torch.zeros(1, 3, 3, 3, 16)
    w = torch.zeros(3, 3, 3, 16)
    with pytest.raises(ValueError):
        tdc.dwconv3(x, w, torch.zeros(bias_shape))


def test_wrong_kernel_shape_raises():
    with pytest.raises(ValueError):
        tdc.dwconv3(torch.zeros(1, 3, 3, 3, 16), torch.zeros(3, 3, 3, 8))
