"""The port's params-npz checkpoints and `convert_state_dict` against the
JAX package's: the same parameter tree from the same `state_dict`, npz
files that load in either package, and an exact round trip npz →
`state_dict_from_jax` → `convert_state_dict`.
"""

import os

import numpy as np
import pytest
import torch

from waveformer_tpu.training import checkpoint as jck
from waveformer_tpu.utils.torch_port import convert_state_dict as jax_convert
from waveformer_tpu_torch.models import create_waveformer
from waveformer_tpu_torch.training import checkpoint as tck
from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax
from waveformer_tpu_torch.utils.torch_port import convert_state_dict

SMALL = dict(img_size=(32, 32, 32), patch_size=2, in_chans=2, out_chans=3,
             embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1), num_heads=(2, 4, 8, 8),
             decom_levels=(3, 2, 1, 0), drop_path_rate=0.0)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_trees_equal(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert list(got) == list(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))


def _model(hf_refinement, seed=3):
    return create_waveformer(dict(SMALL, hf_refinement=hf_refinement), device="cpu", seed=seed)


@pytest.mark.parametrize("hf_refinement", [False, True])
def test_convert_state_dict_matches_jax(hf_refinement):
    sd = _model(hf_refinement).state_dict()
    kw = dict(depths=SMALL["depths"], hf_refinement=hf_refinement)
    _assert_trees_equal(convert_state_dict(sd, **kw), jax_convert(sd, **kw))
    prefixed = {f"module.{k}": v for k, v in sd.items()}
    _assert_trees_equal(convert_state_dict(prefixed, **kw), jax_convert(prefixed, **kw))
    with pytest.raises(ValueError, match="unconverted"):
        convert_state_dict({**sd, "extra.weight": torch.zeros(1)}, **kw)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_in_either_package(tmp_path, writer):
    params = convert_state_dict(_model(False).state_dict(), depths=SMALL["depths"])
    path = str(tmp_path / "model" / "best_model_0.9000_x.npz")
    save = tck.save_params_npz if writer == "port" else jck.save_params_npz
    save(params, path, metadata={"epoch": 3})
    got, want = tck.load_params_npz(path), jck.load_params_npz(path)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, params)
    with np.load(path) as z:
        other = str(tmp_path / "other.npz")
        (jck.save_params_npz if writer == "port" else tck.save_params_npz)(params, other)
        with np.load(other) as y:
            assert z.files == y.files
    with open(path + ".json") as f:
        assert f.read() == '{"epoch": 3}'


def test_find_best_matches_jax(tmp_path):
    directory = str(tmp_path / "model")
    assert tck.CheckpointManager(directory).find_best() is None
    params = convert_state_dict(_model(False).state_dict(), depths=SMALL["depths"])
    tck.save_params_npz(params, os.path.join(directory, "best_model_0.8100_x.npz"))
    tck.save_params_npz(params, os.path.join(directory, "final_model_0.8000_x.npz"))
    got = tck.CheckpointManager(directory).find_best()
    assert got == jck.CheckpointManager(directory).find_best()
    assert got.endswith("best_model_0.8100_x.npz")


@pytest.mark.parametrize("hf_refinement", [False, True])
def test_round_trip_is_exact(tmp_path, hf_refinement):
    model = _model(hf_refinement)
    kw = dict(depths=SMALL["depths"], hf_refinement=hf_refinement)
    path = str(tmp_path / "p.npz")
    jck.save_params_npz(jax_convert(model.state_dict(), **kw), path)
    params = tck.load_params_npz(path)
    sd = state_dict_from_jax(params, **kw)
    _assert_trees_equal(convert_state_dict(sd, **kw), params)
    fresh = _model(hf_refinement, seed=9)
    fresh.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
