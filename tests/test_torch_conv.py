"""The port's dense 3³ conv, fused conv and fused res block against JAX.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the JAX Pallas kernels run in interpret mode (`waveformer_tpu/ops/
conv_pallas.py`, `tools/exp_fused_conv.py`), as the JAX package's own tests
run them, and against the XLA composition `_res_block_xla`. Everything is
fp32: convs and statistics summed in other orders agree to 1e-4. Weights of
the res block are drawn in the JAX `UnetResBlock`'s `init` shapes and carried
into the port's module with `utils/jax_params.py`.

The CUDA kernel itself is held against these plain versions on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import exp_fused_conv as jfc
from waveformer_tpu.models import conv_blocks as jcb
from waveformer_tpu.ops import conv_pallas as jcp
from waveformer_tpu_torch.models import conv_blocks as tcb
from waveformer_tpu_torch.ops import _build
from waveformer_tpu_torch.ops import conv_cuda as tcc
from waveformer_tpu_torch.ops import fused_conv_cuda as tfc
from waveformer_tpu_torch.utils import jax_params as jp

# the shapes of tests/test_conv_pallas.py: (D, H, W), C, O
PALLAS_SHAPES = [((8, 8, 16), 4, 8), ((4, 16, 8), 6, 5)]


def _xw(dhw, cin, cout, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = ((batch,) if batch else ()) + tuple(dhw) + (cin,)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    return x, w


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, rtol=1e-4, atol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


class TestConvSame:
    @pytest.mark.parametrize("dhw,cin,cout", PALLAS_SHAPES)
    def test_matches_jax_kernel(self, dhw, cin, cout):
        x, w = _xw(dhw, cin, cout)
        want = jcp.conv3x3x3_same(jnp.asarray(x), jnp.asarray(w), block_h=4, interpret=True)
        before = dict(tcc.launches)
        _close(tcc.conv3x3x3_same(*_t(x, w), block_h=4), want, rtol=0)
        assert tcc.launches == before  # CPU tensors take the plain version

    def test_batched_matches_jax_kernel(self):
        x, w = _xw((4, 8, 8), 3, 4, batch=2)
        want = jcp.conv3x3x3_batched(jnp.asarray(x), jnp.asarray(w), block_h=4, interpret=True)
        _close(tcc.conv3x3x3_batched(*_t(x, w), block_h=4), want, rtol=0)

    @pytest.mark.parametrize("dhw,cin,cout", PALLAS_SHAPES)
    def test_v2_and_cw_match_jax_kernel(self, dhw, cin, cout):
        x, w = _xw(dhw, cin, cout, seed=1)
        jx, jw = jnp.asarray(x), jnp.asarray(w)
        want = jcp.conv3x3x3_same_v2(jx, jw, block_h=4, interpret=True)
        _close(tcc.conv3x3x3_same_v2(*_t(x, w), block_h=4), want, rtol=0)
        x_cw = np.ascontiguousarray(x.transpose(0, 1, 3, 2))
        want_cw = jcp.conv3x3x3_cw(jnp.asarray(x_cw), jw, block_h=4, interpret=True)
        _close(tcc.conv3x3x3_cw(*_t(x_cw, w), block_h=4), want_cw, rtol=0)

    def test_batched_cw_is_per_instance(self):
        x, w = _xw((4, 8, 8), 5, 3, batch=2)
        x_cw = x.transpose(0, 1, 2, 4, 3)
        got = tcc.conv3x3x3_cw(*_t(x_cw, w))
        for i in range(2):
            _close(got[i], tcc.conv3x3x3_cw(*_t(x_cw[i], w)), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("fn", [tcc.conv3x3x3_same, tcc.conv3x3x3_same_v2])
    def test_indivisible_h_raises(self, fn):
        with pytest.raises(ValueError):
            fn(torch.zeros(4, 6, 8, 3), torch.zeros(3, 3, 3, 3, 4), block_h=4)
        with pytest.raises(ValueError):
            tcc.conv3x3x3_batched(torch.zeros(1, 4, 6, 8, 3), torch.zeros(3, 3, 3, 3, 4),
                                  block_h=4)


def _prologue(batch, cin, seed):
    rng = np.random.default_rng(seed)
    mean = (0.5 + 0.3 * rng.standard_normal((batch, cin))).astype(np.float32)
    rstd = (1.0 + 0.5 * rng.random((batch, cin))).astype(np.float32)
    return mean, rstd


class TestConvFused:
    # H = 8 is the JAX kernel's smallest row block; the D and W borders and a
    # nonzero mean make a normalised padded zero visible
    @pytest.mark.parametrize("pro,act,stats", list(itertools.product((False, True), repeat=3)))
    def test_matches_jax_kernel(self, pro, act, stats):
        x, w = _xw((3, 8, 5), 5, 6, seed=2, batch=2)
        mean, rstd = _prologue(2, 5, seed=3)
        got = tfc.conv3x3x3_fused(*_t(x, w), prologue=tuple(_t(mean, rstd)) if pro else None,
                                  emit_stats=stats, act=act)
        for i in range(2):
            want = jfc.conv3x3x3_fused(
                jnp.asarray(x[i]), jnp.asarray(w),
                prologue=(jnp.asarray(mean[i]), jnp.asarray(rstd[i])) if pro else None,
                emit_stats=stats, act=act, interpret=True)
            if stats:
                _close(got[0][i], want[0])
                scale = float(np.abs(np.asarray(want[1])).max())
                _close(got[1][i], want[1], atol=1e-4 * scale)
            else:
                _close(got[i], want)

    def test_prologue_keeps_the_halo_zero(self):
        # a constant input normalised to exactly 0 inside the volume gives 0
        # everywhere only if the padded border is also 0 after normalisation
        x = torch.full((1, 3, 4, 5, 2), 2.0)
        w = torch.ones(3, 3, 3, 2, 3)
        pro = (torch.full((1, 2), 2.0), torch.ones(1, 2))
        y = tfc.conv3x3x3_fused(x, w, prologue=pro, act=False)
        assert float(y.abs().max()) == 0.0

    def test_moments_from_stats_matches_jax(self):
        rng = np.random.default_rng(4)
        st = np.stack([rng.standard_normal(7) * 10, rng.random(7) * 50 + 1]).astype(np.float32)
        st[1, 0] = 0.0  # a negative E[x²] − E[x]², clamped
        jm, jr = jfc.moments_from_stats(jnp.asarray(st), 9)
        tm, tr = tfc.moments_from_stats(torch.from_numpy(st), 9)
        _close(tm, jm, atol=0)
        _close(tr, jr)

    def test_cpu_does_not_count_launches(self):
        x, w = _xw((2, 8, 3), 3, 4, batch=1)
        before = tfc.launches
        tfc.conv3x3x3_fused(*_t(x, w), emit_stats=True)
        assert tfc.launches == before


def _jax_res_params(cin, cout, seed):
    """Seeded numpy weights in the JAX `UnetResBlock`'s init shapes."""
    m = jcb.UnetResBlock(out_channels=cout)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 4, cin))))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1])))
        .astype(np.float32), shapes)


def _raw(p, name):
    return p["params"][name]["conv"]["kernel"] if name in p["params"] else None


class TestResBlockFused:
    @pytest.mark.parametrize("cin,cout", [(5, 6), (6, 6)])  # with and without the shortcut
    def test_matches_jax_res_block(self, cin, cout):
        p = _jax_res_params(cin, cout, seed=5)
        x = np.random.default_rng(6).standard_normal((2, 3, 8, 5, cin)).astype(np.float32)
        ws = [_raw(p, n) for n in ("conv1", "conv2", "conv3")]
        assert (ws[2] is None) == (cin == cout)
        tw = [None if w is None else torch.from_numpy(np.asarray(w)) for w in ws]
        got = tfc.res_block_fused(torch.from_numpy(x), *tw)
        block = tcb.UnetResBlock(cin, cout)
        sd = {}
        jp.unet_block(sd, p["params"], "")
        block.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        got_module = tfc.res_block_fused_module(block, torch.from_numpy(x))
        with torch.no_grad():
            got_plain = block(torch.from_numpy(x))
        for i in range(2):
            want = jfc._res_block_xla(jnp.asarray(x[i]), *[None if w is None else jnp.asarray(w)
                                                           for w in ws])
            _close(got[i], want)
            _close(got_module[i], want)
            _close(got_plain[i], want)
        _close(tfc.res_block_reference(torch.from_numpy(x), *tw), got)

    @pytest.mark.parametrize("cin,cout", [(5, 6), (6, 6)])
    def test_gradients_match_jax_vjp(self, cin, cout):
        p = _jax_res_params(cin, cout, seed=7)
        rng = np.random.default_rng(8)
        x = rng.standard_normal((1, 3, 8, 4, cin)).astype(np.float32)
        g = rng.standard_normal((1, 3, 8, 4, cout)).astype(np.float32)
        ws = [np.asarray(w) for w in (_raw(p, "conv1"), _raw(p, "conv2"), _raw(p, "conv3"))
              if w is not None]
        if cin == cout:
            _, vjp = jax.vjp(lambda a, b, c: jfc._res_block_xla(a, b, c, None),
                             jnp.asarray(x[0]), *map(jnp.asarray, ws))
        else:
            _, vjp = jax.vjp(jfc._res_block_xla, jnp.asarray(x[0]), *map(jnp.asarray, ws))
        want = vjp(jnp.asarray(g[0]))
        ts = [torch.from_numpy(a).requires_grad_(True) for a in [x] + ws]
        out = tfc.res_block_fused(*ts, *([None] if cin == cout else []))
        out.backward(torch.from_numpy(g))
        _close(ts[0].grad[0], want[0])
        for t, wnt in zip(ts[1:], want[1:]):
            _close(t.grad, wnt, atol=1e-4 * float(np.abs(np.asarray(wnt)).max()))


def test_sources_cover_the_new_kernels():
    assert {"conv3", "ffn_tail"} <= set(_build.sources())
