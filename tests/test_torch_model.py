"""The port's modules and model against the JAX package (CPU, fp32).

JAX parameters are drawn with a seeded numpy generator in the shapes
`init` would make (`jax.eval_shape`, so nothing compiles for init) and are
carried into the port with `utils/jax_params.py`, the inverse of
`waveformer_tpu/utils/torch_port.py::convert_state_dict`. Module outputs
agree to 1e-4 (fp32 convs, norms and matmuls summed in other orders; the
JAX GELU is a polynomial erf within 1.5e-7); the toy model's logits to
2e-4.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.models import Waveformer as JaxWaveformer
from waveformer_tpu.models import attention as ja
from waveformer_tpu.models import blocks as jb
from waveformer_tpu.models import conv_blocks as jcb
from waveformer_tpu.models import decoder as jd
from waveformer_tpu.models import layers as jl
from waveformer_tpu.utils.torch_port import convert_state_dict
from waveformer_tpu_torch.models import attention as ta
from waveformer_tpu_torch.models import blocks as tb
from waveformer_tpu_torch.models import conv_blocks as tcb
from waveformer_tpu_torch.models import decoder as td
from waveformer_tpu_torch.models import layers as tl
from waveformer_tpu_torch.config import Config
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.utils import jax_params as jp

SMALL = dict(
    img_size=(32, 32, 32),
    patch_size=2,
    in_chans=2,
    out_chans=3,
    embed_dims=(8, 16, 32, 64),
    depths=(1, 1, 1, 1),
    num_heads=(2, 4, 8, 8),
    decom_levels=(3, 2, 1, 0),
    drop_path_rate=0.0,
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_params(module, *args, seed=0):
    """Seeded numpy parameters in the shapes `module.init` would make."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "relative_position_bias_table":
            return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
        fan_in = max(int(np.prod(s.shape[:-1])), 1)
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(module: torch.nn.Module, convert, params, *extra) -> torch.nn.Module:
    sd = {}
    convert(sd, params["params"], "", *extra)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, atol=1e-4):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol)


class TestModules:
    def test_window_attention(self):
        x = _x((2, 512, 48))
        jm = ja.WindowAttention(dim=48, num_heads=3, window_size=8)
        p = random_params(jm, jnp.asarray(x))
        tm = load(ta.WindowAttention(48, 3, 8), jp.window_attention, p)
        _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(p, jnp.asarray(x)))

    def test_ccf_ffn(self):
        x = _x((2, 5, 6, 7, 8))
        jm = jl.CCF_FFN(hidden_features=32)
        p = random_params(jm, jnp.asarray(x))
        tm = load(tl.CCF_FFN(8, 32), jp.ccf_ffn, p)
        _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(p, jnp.asarray(x)))

    def test_patch_merging(self):
        x = _x((2, 8, 8, 8, 8))
        jm = jl.PatchMerging(dim=8)
        p = random_params(jm, jnp.asarray(x))
        tm = load(tl.PatchMerging(8), jp.patch_merging, p)
        _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(p, jnp.asarray(x)))

    @pytest.mark.parametrize("stride,double", [(2, False), (4, True)])
    def test_projection_upsample(self, stride, double):
        x = _x((1, 4, 4, 4, 16))
        jm = jl.ProjectionUpsample(16, 8, stride=stride, use_double_conv=double)
        p = random_params(jm, jnp.asarray(x))
        tm = load(tl.ProjectionUpsample(16, 8, stride=stride, use_double_conv=double),
                  jp.projection_upsample, p)
        _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(p, jnp.asarray(x)))

    @pytest.mark.parametrize("level,ms", [(2, True), (2, False), (0, True), (1, True)])
    def test_waveformer_block(self, level, ms):
        x = _x((2, 8, 8, 8, 16))
        kw = dict(dim=16, num_heads=2, level=level, img_size=(8, 8, 8), ms_attention=ms)
        jm = jb.WaveFormerBlock(**kw)
        p = random_params(jm, jnp.asarray(x))
        tm = load(tb.WaveFormerBlock(16, 2, level, (8, 8, 8), ms_attention=ms),
                  jp.waveformer_block, p)
        jy, jh = jax.jit(jm.apply)(p, jnp.asarray(x))
        ty, th = tm(torch.from_numpy(x))
        _close(ty, jy)
        assert len(th) == len(jh) == level
        for tdet, jdet in zip(th, jh):
            for k in jdet:
                _close(tdet[k], jdet[k])

    @pytest.mark.parametrize("hf_refinement", [False, True])
    def test_idwt_block(self, hf_refinement):
        inp, skip = _x((2, 2, 2, 2, 16), 1), _x((2, 8, 8, 8, 8), 2)
        keys = ("aad", "ada", "add", "daa", "dad", "dda", "ddd")
        hfs = [{k: _x((2, n, n, n, 8), 3 + i) for i, k in enumerate(keys)} for n in (2, 4)]
        jm = jd.UnetrIDWTBlock(8, stage=2, hf_refinement=hf_refinement)
        jhf = [{k: jnp.asarray(v) for k, v in d.items()} for d in hfs]
        p = random_params(jm, jnp.asarray(inp), jnp.asarray(skip), jhf)
        tm = load(td.UnetrIDWTBlock(16, 8, 2, hf_refinement=hf_refinement),
                  jp.idwt_block, p, 2, hf_refinement)
        thf = [{k: torch.from_numpy(v) for k, v in d.items()} for d in hfs]
        _close(tm(torch.from_numpy(inp), torch.from_numpy(skip), thf),
               jax.jit(jm.apply)(p, jnp.asarray(inp), jnp.asarray(skip), jhf))

    def test_channel_calibration(self):
        x = _x((2, 4, 4, 4, 16))
        jm = jcb.ChannelCalibration(16)
        p = random_params(jm, jnp.asarray(x))
        tm = load(tcb.ChannelCalibration(16), jp.channel_calibration, p)
        _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(p, jnp.asarray(x)))

    def test_up_block(self):
        x, skip = _x((2, 4, 4, 4, 24), 1), _x((2, 8, 8, 8, 8), 2)
        jm = jcb.UnetrUpBlock(8)
        p = random_params(jm, jnp.asarray(x), jnp.asarray(skip))
        tm = load(tcb.UnetrUpBlock(24, 8), jp.up_block, p)
        _close(tm(torch.from_numpy(x), torch.from_numpy(skip)),
               jax.jit(jm.apply)(p, jnp.asarray(x), jnp.asarray(skip)))


def _model_pair(cfg, shape, seed=0):
    x = _x(shape, seed + 10)
    jm = JaxWaveformer(**cfg, io_layout="channels_first")
    p = random_params(jm, jnp.asarray(x), seed=seed)
    tm = create_waveformer(cfg, device="cpu", io_layout="channels_first")
    # the model's default depths where cfg names none (the flagship)
    depths = {**Config().network.model_kwargs(), **cfg}["depths"]
    tm.load_state_dict(
        jp.state_dict_from_jax(p, depths=depths,
                               hf_refinement=cfg.get("hf_refinement", False)),
        strict=True,
    )
    return x, jm, p, tm


class TestWaveformer:
    @pytest.mark.parametrize("variant", [{}, {"multi_scale_attention": False}])
    def test_toy_model_matches_jax(self, variant):
        cfg = {**SMALL, **variant}
        x, jm, p, tm = _model_pair(cfg, (1, 2, 32, 32, 32))
        with torch.no_grad():
            ty = tm(torch.from_numpy(x))
        jy = jax.jit(jm.apply)(p, jnp.asarray(x))
        assert ty.shape == (1, 3, 32, 32, 32)
        _close(ty, jy, atol=2e-4)

    def test_weights_roundtrip_through_convert_state_dict(self):
        cfg = {**SMALL, "hf_refinement": True}
        jm = JaxWaveformer(**cfg, io_layout="channels_first")
        p = random_params(jm, jnp.zeros((1, 2, 32, 32, 32)), seed=3)
        sd = jp.state_dict_from_jax(p, depths=cfg["depths"], hf_refinement=True)
        tm = create_waveformer(cfg, device="cpu", io_layout="channels_first")
        tm.load_state_dict(sd, strict=True)
        back = convert_state_dict(tm.state_dict(), depths=cfg["depths"],
                                  hf_refinement=True, strict=True)
        want = dict(jax.tree_util.tree_leaves_with_path(p))
        got = dict(jax.tree_util.tree_leaves_with_path(back))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))

    def test_reference_keys_and_param_count(self):
        tm = create_waveformer(device="cpu")
        keys = set(tm.state_dict())
        for k in ("waveformer_encoder.block1.0.attn.qkv.weight",
                  "waveformer_encoder.block1.0.attn.relative_position_index",
                  "learnable_up4.conv1.1.weight", "learnable_up4.conv3.0.weight",
                  "learnable_up4.conv3.2.weight", "learnable_up4.res_conv.1.weight",
                  "decoder4.conv_lf_block.conv.weight",
                  "decoder1.transp_conv.conv.weight", "out.conv.conv.weight"):
            assert k in keys, k
        # the torch reference at the BraTS config (tests/test_model.py)
        assert sum(p.numel() for p in tm.parameters()) == 17_167_546

    def test_bf16_keeps_bias_table_fp32(self):
        tm = create_waveformer(SMALL, dtype=torch.bfloat16, device="cpu",
                               io_layout="channels_first")
        attn = tm.waveformer_encoder.block1[0].attn
        assert attn.relative_position_bias_table.dtype == torch.float32
        assert attn.qkv.weight.dtype == torch.bfloat16
        with torch.no_grad():
            y = tm(torch.zeros(1, 2, 32, 32, 32))
        assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()

    def test_deep_supervision_shapes(self):
        tm = create_waveformer({**SMALL, "deep_supervision": True}, device="cpu",
                               io_layout="channels_first")
        with torch.no_grad():
            outs = tm(torch.zeros(1, 2, 32, 32, 32))
        assert [tuple(o.shape) for o in outs] == [
            (1, 3, 32, 32, 32), (1, 3, 16, 16, 16), (1, 3, 8, 8, 8)
        ]

    @pytest.mark.slow
    def test_flagship_matches_jax(self):
        cfg = dict(img_size=(128, 128, 128), drop_path_rate=0.0)
        x, jm, p, tm = _model_pair(cfg, (1, 4, 128, 128, 128))
        with torch.no_grad():
            ty = tm(torch.from_numpy(x))
        _close(ty, jax.jit(jm.apply)(p, jnp.asarray(x)), atol=2e-4)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import waveformer_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'waveformer_tpu', 'tools', 'yaml', 'nibabel')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_create_waveformer_refuses_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_waveformer(SMALL)
    with pytest.raises(RuntimeError):
        create_waveformer(SMALL, device="cuda")
