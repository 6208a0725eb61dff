"""The port's two kernel functions against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the JAX kernel run in Pallas interpret mode, as the JAX package's own tests
run it. Forward tolerances are those of the JAX kernel tests (fp32 scores
and softmax summed in another order); gradients go through the plain
backward on both sides (atol 1e-3, as the JAX tests).

The kernels themselves are held against these plain versions on the card
by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.ops import attention_pallas as jap
from waveformer_tpu.ops import dwconv_pallas as jdp
from waveformer_tpu_torch.ops import _build
from waveformer_tpu_torch.ops import attention_cuda as tac
from waveformer_tpu_torch.ops import dwconv_cuda as tdc

ATTN_SHAPES = [(4, 3, 512, 16), (2, 24, 512, 16), (3, 2, 128, 8)]


def _qkvb(bw, h, n, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bw, h, n, d).astype(np.float32) for _ in range(3))
    b = (rng.randn(h, n, n) * 0.5).astype(np.float32)
    return q, k, v, b


class TestWindowAttentionPlain:
    @pytest.mark.parametrize("bw,h,n,d", ATTN_SHAPES)
    def test_matches_jax_kernel(self, bw, h, n, d):
        q, k, v, b = _qkvb(bw, h, n, d)
        want = jap.window_attention(*map(jnp.asarray, (q, k, v, b)), d**-0.5, True)
        before = tac.launches
        got = tac.window_attention(*map(torch.from_numpy, (q, k, v, b)), d**-0.5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        assert tac.launches == before  # CPU tensors take the plain version

    def test_gradients_match_jax(self):
        bw, h, n, d = 2, 2, 128, 8
        q, k, v, b = _qkvb(bw, h, n, d, seed=1)
        gj = jax.grad(
            lambda *a: jnp.sum(jap.window_attention(*a, d**-0.5, True) ** 2),
            argnums=(0, 1, 2, 3),
        )(*map(jnp.asarray, (q, k, v, b)))
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, b)]
        (tac.window_attention(*ts, d**-0.5) ** 2).sum().backward()
        for t, g in zip(ts, gj):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-3)

    def test_supported_predicate(self):
        for _, _, n, d in ATTN_SHAPES:
            assert tac.supported(n, d)
        assert tac.supported(1024, 64)
        assert not tac.supported(500, 16)   # ragged N
        assert not tac.supported(2048, 16)  # bias rows would not fit
        assert not tac.supported(512, 12)   # not whole 8-element vectors
        assert not tac.supported(512, 128)  # register budget


class TestDWConv3Plain:
    @pytest.mark.parametrize("shape", [(2, 6, 5, 7, 96), (1, 3, 4, 4, 24)])
    def test_matches_jax_kernel(self, shape):
        rng = np.random.default_rng(0)
        x = rng.standard_normal(shape).astype(np.float32)
        w = rng.standard_normal((3, 3, 3, shape[-1])).astype(np.float32)
        want = jdp.dwconv3(jnp.asarray(x), jnp.asarray(w), True)
        before = tdc.launches
        got = tdc.dwconv3(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert tdc.launches == before

    def test_gradients_match_jax(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((1, 3, 4, 4, 16)).astype(np.float32)
        w = rng.standard_normal((3, 3, 3, 16)).astype(np.float32)
        gj = jax.grad(lambda a, k: jnp.sum(jdp.dwconv3(a, k, True) ** 2), (0, 1))(
            jnp.asarray(x), jnp.asarray(w)
        )
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        (tdc.dwconv3(xt, wt) ** 2).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj[0]), atol=1e-3)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj[1]), atol=1e-3)

    def test_supported(self):
        assert all(tdc.supported(c) for c in (96, 192, 384, 768, 1536, 8))
        assert not tdc.supported(20)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_sources_cover_both_kernels():
    assert {"window_attention", "dwconv3"} <= set(_build.sources())
