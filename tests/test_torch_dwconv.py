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


# the backward's shapes on the CPU: C % 8 != 0 and sizes of 1 on D, H and W
BACKWARD_SHAPES = [(1, 4, 5, 6, 8), (2, 3, 4, 5, 12), (1, 1, 4, 3, 20), (1, 5, 1, 4, 4),
                   (2, 3, 4, 1, 16), (1, 1, 1, 1, 7), (1, 6, 5, 7, 96)]


def _f64_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x, g = (torch.from_numpy(rng.standard_normal(shape)) for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, shape[-1])))
    return x, w, g


@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
def test_input_gradient_is_the_flipped_stencil(shape):
    # the card's dgrad: the forward stencil of g with the taps flipped on all
    # three axes; float64 sums of the same 27 terms in another order
    x, w, g = _f64_inputs(shape, 4)
    dx, _, _ = tdc.dwconv3_backward(x, w, g)
    assert dx.dtype == torch.float64
    want = tdc.dwconv3_reference(g, w.flip((0, 1, 2)))
    torch.testing.assert_close(dx, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
def test_weight_gradients_match_autograd_f64(shape):
    # what the card's wgrad sums: Σ over voxels of each tap's shifted x
    # times g, and Σ g; against the autograd of `F.conv3d` in float64
    x, w, g = _f64_inputs(shape, 5)
    b = torch.zeros(shape[-1], dtype=torch.float64)
    ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
    tdc.dwconv3_reference(*ins).backward(g)
    _, dk, db = tdc.dwconv3_backward(x, w, g)
    torch.testing.assert_close(dk, ins[1].grad, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(db, ins[2].grad, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_cpu_backward_takes_the_plain_path(dtype, with_bias):
    x, w, b = _inputs((1, 3, 4, 5, 12), 6)
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True) if with_bias else None
    y = tdc.dwconv3(xt, wt, bt)
    counts = (tdc.launches, dict(tdc.design_launches), dict(tdc.backward_design_launches))
    g = torch.ones_like(y)
    y.backward(g)
    assert (tdc.launches, tdc.design_launches, tdc.backward_design_launches) == counts
    want = tdc.dwconv3_backward(xt.detach(), wt.detach(), g)
    assert torch.equal(xt.grad, want[0].to(dtype)) and torch.equal(wt.grad, want[1])
    assert bt is None or torch.equal(bt.grad, want[2])
    assert set(tdc.backward_design_launches) == set(tdc.BACKWARD_DESIGNS) == {
        "dgrad_vector", "dgrad_tma_ring", "wgrad_vector", "wgrad_tma_ring"}
