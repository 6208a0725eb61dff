"""Parity of the port's plain ops with the JAX package (CPU, fp32).

Inputs come from a seeded numpy generator and go through the JAX function
and its `waveformer_tpu_torch` counterpart. Tolerances: 1e-6 for the
Haar wavelet and the resize (a few fp32 adds/FMAs per output, in a
different order), exact for the window reshapes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveformer_tpu.config import Config as JaxConfig
from waveformer_tpu.models.attention import relative_position_index as jax_rpi
from waveformer_tpu.ops import resize as jrs
from waveformer_tpu.ops import wavelet as jwv
from waveformer_tpu.ops import window as jwin
from waveformer_tpu_torch.config import Config
from waveformer_tpu_torch.models.attention import relative_position_index
from waveformer_tpu_torch.ops import resize as trs
from waveformer_tpu_torch.ops import wavelet as twv
from waveformer_tpu_torch.ops import window as twin


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class TestWavelet:
    @pytest.mark.parametrize("shape", [(2, 6, 6, 6, 3), (1, 7, 9, 5, 2), (1, 5, 4, 3, 4)])
    def test_dwt3_idwt3_match_jax(self, shape):
        x = _rand(shape)
        jl, jd = jwv.dwt3(jnp.asarray(x))
        tl, td = twv.dwt3(torch.from_numpy(x))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
        assert tuple(td) == twv.DETAIL_KEYS == jwv.DETAIL_KEYS
        for k in twv.DETAIL_KEYS:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), atol=1e-6)
        jr = jwv.idwt3(jl, jd)
        tr = twv.idwt3(tl, td)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)

    @pytest.mark.parametrize("shape,level", [((1, 16, 8, 12, 3), 2), ((2, 7, 9, 5, 2), 2),
                                             ((1, 8, 8, 8, 4), 3)])
    def test_wavedec_waverec_match_jax(self, shape, level):
        x = _rand(shape, 1)
        jc = jwv.wavedec3(jnp.asarray(x), level=level)
        tc = twv.wavedec3(torch.from_numpy(x), level=level)
        np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), atol=1e-6)
        for jd, td in zip(jc[1:], tc[1:]):
            for k in twv.DETAIL_KEYS:
                np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), atol=1e-6)
        np.testing.assert_allclose(
            twv.waverec3(tc).numpy(), np.asarray(jwv.waverec3(jc)), atol=1e-6
        )

    def test_channels_first_axes(self):
        # NCDHW splits D, then H, then W (as the JAX cascade does);
        # channels-last 5-D input splits W, H, D (the JAX phase path's order,
        # which rounds otherwise), so the helper is given NCDHW's order here
        x = _rand((2, 6, 8, 4, 3), 2)
        cl_l, cl_d = twv._dwt3_cascade(torch.from_numpy(x), (1, 2, 3), (0, 1, 2))
        cf_l, cf_d = twv.dwt3(torch.from_numpy(x).permute(0, 4, 1, 2, 3), axes=(2, 3, 4))
        np.testing.assert_array_equal(cf_l.permute(0, 2, 3, 4, 1).numpy(), cl_l.numpy())
        np.testing.assert_array_equal(
            cf_d["dad"].permute(0, 2, 3, 4, 1).numpy(), cl_d["dad"].numpy()
        )

    @pytest.mark.parametrize("fname", [
        "wavelet_db1_6x6x6_l1.npz",
        "wavelet_db1_7x9x5_l2.npz",
        "wavelet_db1_8x12x10_l2.npz",
    ])
    def test_wavedec3_matches_fixture(self, fname):
        z = np.load(os.path.join(os.path.dirname(__file__), "fixtures", fname))
        level = int(z["level"])
        x = z["x"]  # (C, D, H, W)
        coeffs = twv.wavedec3(torch.from_numpy(x.transpose(1, 2, 3, 0)[None].copy()),
                              level=level)
        for c in range(x.shape[0]):
            np.testing.assert_allclose(coeffs[0][0, ..., c].numpy(), z[f"c{c}_lf"],
                                       atol=1e-6)
            for li, det in enumerate(coeffs[1:]):
                for k in twv.DETAIL_KEYS:
                    np.testing.assert_allclose(
                        det[k][0, ..., c].numpy(), z[f"c{c}_l{li}_{k}"], atol=1e-6
                    )

    def test_other_wavelets_raise(self):
        x = torch.zeros(1, 4, 4, 4, 1)
        with pytest.raises(ValueError):
            twv.dwt3(x, wavelet="db2")
        with pytest.raises(ValueError):
            twv.wavedec3(x, wavelet="sym4", level=1)


class TestWindow:
    @pytest.mark.parametrize("shape,ws", [((2, 8, 8, 8, 3), 4), ((1, 4, 8, 6, 2), 2),
                                          ((1, 8, 8, 8, 5), 8)])
    def test_partition_and_flat_merge_exact(self, shape, ws):
        x = _rand(shape, 3)
        jw = np.asarray(jwin.window_partition(jnp.asarray(x), ws))
        tw = twin.window_partition(torch.from_numpy(x), ws).numpy()
        np.testing.assert_array_equal(tw, jw)
        grid = shape[1:4]
        jm = np.asarray(jwin.window_unpartition_flat(jnp.asarray(jw), ws, grid))
        tm = twin.window_unpartition_flat(torch.from_numpy(tw), ws, grid).numpy()
        np.testing.assert_array_equal(tm, jm)


class TestResize:
    @pytest.mark.parametrize("align_corners", [False, True])
    @pytest.mark.parametrize("shape,out", [((1, 4, 4, 4, 3), (8, 8, 8)),
                                           ((2, 3, 5, 4, 2), (12, 10, 16)),
                                           ((1, 3, 4, 5, 2), (7, 8, 11))])
    def test_matches_jax(self, shape, out, align_corners):
        x = _rand(shape, 4)
        j = np.asarray(jrs.resize_trilinear(jnp.asarray(x), out, align_corners=align_corners))
        t = trs.resize_trilinear(torch.from_numpy(x), out, align_corners=align_corners)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-6)
        tcf = trs.resize_trilinear(torch.from_numpy(x).permute(0, 4, 1, 2, 3), out,
                                   align_corners=align_corners, axes=(2, 3, 4))
        np.testing.assert_allclose(tcf.permute(0, 2, 3, 4, 1).numpy(), j, atol=1e-6)

    @pytest.mark.parametrize("align_corners", [False, True])
    def test_downsample_matches_jax(self, align_corners):
        # F.interpolate weighs the 8 corners in one pass where the JAX op
        # contracts one axis at a time: the fp32 sums differ by a few ulp,
        # so this case is held to a relative 1e-5
        x = _rand((1, 8, 8, 8, 2), 5)
        j = np.asarray(jrs.resize_trilinear(jnp.asarray(x), (5, 8, 3),
                                            align_corners=align_corners))
        t = trs.resize_trilinear(torch.from_numpy(x), (5, 8, 3),
                                 align_corners=align_corners)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-6)


def test_config_defaults_match_jax():
    assert Config().network.model_kwargs() == JaxConfig().network.model_kwargs()
    assert Config().roi_size == JaxConfig().roi_size


@pytest.mark.parametrize("example", ["brats2023", "abdomen_ct"])
def test_load_config_matches_jax(example):
    from waveformer_tpu.config import load_config as jax_load
    from waveformer_tpu_torch.config import load_config

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples",
                        example, "config.yaml")
    got, want = load_config(path), jax_load(path)
    assert got.network.model_kwargs() == want.network.model_kwargs()
    assert got.roi_size == want.roi_size


@pytest.mark.parametrize("ws", [2, 4, 8])
def test_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(relative_position_index(ws), jax_rpi(ws))
