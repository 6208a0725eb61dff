"""The port's CCF-FFN tail against JAX (`tools/exp_ffn_pallas.py`).

On the CPU `ffn_tail` runs its plain PyTorch version; it is held against
the JAX Pallas kernel in interpret mode and against the JAX composition
`_ffn_tail_reference`, in fp32 (the JAX GELU is a polynomial erf within
1.5e-7; LayerNorm variance is E[x²] − E[x]² there and two-pass here): 1e-4.
Gradients go through the plain composition on both sides. `ffn_tail_module`
on a port `CCF_FFN` equals the module's own forward and the JAX module's.

The bf16 tail's second launch, `ln_gelu_dense` (LayerNorm → GELU → Dense
over rows of the stencil's output), has a plain version of its own, held
here against the JAX pieces the tail uses (`_ln_f32`, `_gelu_f32` and the
einsum of `_ffn_tail_reference`) in fp32 at 1e-4, at row counts that are no
multiple of the kernel's 64-row blocks. The design rule (bf16 on
`split_wgmma`, fp32 on `fp32`) is pinned without loading a library.

The CUDA kernels are held against the plain versions on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import exp_ffn_pallas as jft
from waveformer_tpu.models import layers as jl
from waveformer_tpu_torch.models import layers as tl
from waveformer_tpu_torch.models.common import gelu
from waveformer_tpu_torch.ops import dwconv_cuda as tdc
from waveformer_tpu_torch.ops import ffn_tail_cuda as tft
from waveformer_tpu_torch.utils import jax_params as jp

EPS = 1e-5


def _args(shape, c_out, seed=0):
    """h1 (B, D, H, W, Ch) and the tail's parameters, seeded numpy fp32."""
    rng = np.random.default_rng(seed)
    ch = shape[-1]
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * rng.standard_normal(s)).astype(np.float32)
    return [f(*shape), f(3, 3, 3, ch, scale=0.3), f(ch, scale=0.1), f(ch, scale=0.1, loc=1.0),
            f(ch, scale=0.1), f(ch, c_out, scale=ch**-0.5), f(c_out, scale=0.1)]


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=atol)


class TestFFNTail:
    # the JAX kernel takes H <= 32 (or a multiple of 32); odd D and W
    @pytest.mark.parametrize("shape,c_out", [((2, 4, 6, 5, 32), 8), ((1, 3, 5, 7, 16), 4)])
    def test_matches_jax_kernel_and_reference(self, shape, c_out):
        a = _args(shape, c_out)
        ja = [jnp.asarray(v) for v in a]
        want_kernel = jft.ffn_tail(*ja, EPS, True)
        want_ref = jft._ffn_tail_reference(*ja, EPS)
        before = tft.launches
        got = tft.ffn_tail(*map(torch.from_numpy, a), eps=EPS)
        assert tft.launches == before  # CPU tensors take the plain version
        assert got.shape == shape[:-1] + (c_out,)
        _close(got, want_kernel)
        _close(got, want_ref)
        _close(tft.ffn_tail_reference(*map(torch.from_numpy, a), EPS), want_ref)

    def test_gradients_match_jax_vjp(self):
        a = _args((1, 3, 4, 5, 16), 8, seed=1)
        g = np.random.default_rng(2).standard_normal((1, 3, 4, 5, 8)).astype(np.float32)
        _, vjp = jax.vjp(lambda *v: jft.ffn_tail(*v, EPS, True), *map(jnp.asarray, a))
        want = vjp(jnp.asarray(g))
        ts = [torch.from_numpy(v).requires_grad_(True) for v in a]
        tft.ffn_tail(*ts, eps=EPS).backward(torch.from_numpy(g))
        for t, w in zip(ts, want):
            _close(t.grad, w, atol=1e-4 * max(1.0, float(np.abs(np.asarray(w)).max())))

    def test_module_path_equals_the_module(self):
        x = np.random.default_rng(3).standard_normal((2, 3, 5, 4, 8)).astype(np.float32)
        jm = jl.CCF_FFN(hidden_features=32)
        rng = np.random.default_rng(4)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        p = jax.tree_util.tree_map(
            lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
        ffn = tl.CCF_FFN(8, 32)
        sd = {}
        jp.ccf_ffn(sd, p["params"], "")
        ffn.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                            strict=True)
        with torch.no_grad():
            got = tft.ffn_tail_module(ffn, torch.from_numpy(x))
            want = ffn(torch.from_numpy(x))
        _close(got, want.numpy())
        _close(got, jm.apply(p, jnp.asarray(x)))

    def test_supported(self):
        for ch, c in ((192, 48), (384, 96), (768, 192), (1536, 384)):
            assert tft.supported(ch, c, torch.bfloat16)
        assert tft.supported(24, 5, torch.float32)
        assert not tft.supported(24, 8, torch.bfloat16)  # 16-deep K steps
        assert not tft.supported(32, 5, torch.bfloat16)  # 8-wide output tiles
        assert not tft.supported(20, 8, torch.float32)   # whole 8-channel vectors


def _lgd_args(m, ch, c_out, seed):
    """y (m, Ch) and the LayerNorm and Dense parameters, seeded numpy fp32;
    y has a nonzero mean per row, as the stencil's output with its bias."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * rng.standard_normal(s)).astype(np.float32)
    return [f(m, ch, loc=0.3), f(ch, scale=0.1, loc=1.0), f(ch, scale=0.1),
            f(ch, c_out, scale=ch**-0.5), f(c_out, scale=0.1)]


class TestLnGeluDense:
    # M = 100, 70, 130: ragged 64-row blocks; the three narrowest flagship-like widths
    @pytest.mark.parametrize("m,ch,c_out", [(100, 16, 8), (70, 64, 16), (130, 192, 48)])
    def test_matches_jax_pieces(self, m, ch, c_out):
        y, ln_s, ln_b, fc_w, fc_b = _lgd_args(m, ch, c_out, seed=ch)
        a = jft._gelu_f32(jft._ln_f32(jnp.asarray(y), ln_s, ln_b, EPS))
        want = jnp.einsum("...c,co->...o", a, jnp.asarray(fc_w)) + fc_b
        ts = [torch.from_numpy(v) for v in (y, ln_s, ln_b, fc_w, fc_b)]
        before = tft.ln_gelu_dense_launches
        got = tft.ln_gelu_dense(*ts, eps=EPS)
        assert tft.ln_gelu_dense_launches == before  # CPU tensors take the plain version
        assert got.shape == (m, c_out) and got.dtype == torch.float32
        _close(got, want)
        _close(tft.ln_gelu_dense_reference(*ts, EPS), want)

    def test_keeps_leading_axes(self):
        y, ln_s, ln_b, fc_w, fc_b = _lgd_args(2 * 3 * 5 * 7, 32, 8, seed=5)
        ts = [torch.from_numpy(v) for v in (y, ln_s, ln_b, fc_w, fc_b)]
        flat = tft.ln_gelu_dense(*ts, eps=EPS)
        got = tft.ln_gelu_dense(ts[0].reshape(2, 3, 5, 7, 32), *ts[1:], eps=EPS)
        assert got.shape == (2, 3, 5, 7, 8)
        torch.testing.assert_close(got.reshape(-1, 8), flat, rtol=0, atol=0)

    def test_split_composes_to_the_tail(self):
        # the bf16 design's two launches: dwconv3 with its bias, then ln_gelu_dense
        a = [torch.from_numpy(v) for v in _args((2, 3, 5, 7, 32), 16, seed=6)]
        h1, dw_w, dw_b, ln_s, ln_b, fc_w, fc_b = a
        y = tdc.dwconv3_reference(h1, dw_w, dw_b)
        got = tft.ln_gelu_dense_reference(y, ln_s, ln_b, fc_w, fc_b, EPS)
        _close(got, tft.ffn_tail_reference(*a, EPS).numpy())

    def test_rounds_a_and_out_to_the_input_dtype(self):
        y, ln_s, ln_b, fc_w, fc_b = (torch.from_numpy(v) for v in _lgd_args(40, 64, 16, seed=7))
        yb = y.to(torch.bfloat16)
        got = tft.ln_gelu_dense_reference(yb, ln_s, ln_b, fc_w, fc_b, EPS)
        a = gelu(torch.nn.functional.layer_norm(yb.float(), (64,), ln_s, ln_b, EPS))
        want = (a.to(torch.bfloat16).float() @ fc_w.to(torch.bfloat16).float() + fc_b)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


class TestDesign:
    @pytest.mark.parametrize("ch,c", [(16, 8), (64, 16), (192, 48), (384, 96), (768, 192),
                                      (1536, 384)])
    def test_design_rule(self, ch, c):
        assert tft.design(torch.bfloat16, ch, c) == "split_wgmma"
        assert tft.design(torch.float32, ch, c) == "fp32"

    def test_designs_are_counted(self):
        assert tft.DESIGNS == ("fp32", "split_wgmma")
        assert set(tft.design_launches) == set(tft.DESIGNS)

    def test_design_needs_no_library(self, monkeypatch):
        def refuse(name):
            raise AssertionError(f"design() loaded the {name} library")

        monkeypatch.setattr(tft._build.LIBRARIES, "get", refuse)
        assert tft.design(torch.bfloat16, 192, 48) == "split_wgmma"
