"""The port's data feed against the JAX package's, on the CPU: every
augmentation transform and stack, `PatchSampler` and the inline
`PrefetchLoader` give arrays `np.array_equal` to JAX's for the same
`RandomState` seed, with the native OpenMP runtime built on both sides and
with it disabled; `PrefetchLoader` with two spawn workers yields the right
count and shapes and shuts down.
"""

import pickle

import numpy as np
import pytest

from waveformer_tpu import runtime as jruntime
from waveformer_tpu.data import augment as ja
from waveformer_tpu.data.dataset import MedicalDataset as JaxDataset
from waveformer_tpu.data.patch_sampler import PatchSampler as JaxSampler
from waveformer_tpu.data.pipeline import PrefetchLoader as JaxLoader
from waveformer_tpu_torch import runtime as truntime
from waveformer_tpu_torch.data import augment as ta
from waveformer_tpu_torch.data.dataset import MedicalDataset
from waveformer_tpu_torch.data.patch_sampler import PatchSampler
from waveformer_tpu_torch.data.pipeline import PrefetchLoader

SHAPE = (20, 24, 16)


@pytest.fixture(params=["native", "numpy"])
def native(request, monkeypatch):
    """Both runtimes built (g++), or both disabled (the scipy fallbacks)."""
    if request.param == "numpy":
        monkeypatch.setattr(jruntime, "_lib", False)
        monkeypatch.setattr(truntime, "_lib", False)
    else:
        assert jruntime.available() and truntime.available()
    return request.param


def _sample(seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((2, *SHAPE)).astype(np.float32)
    seg = rng.integers(-1, 4, (1, *SHAPE)).astype(np.float32)
    return {"data": data, "seg": seg}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


TRANSFORMS = {
    "spatial_order3": lambda m: m.SpatialTransform(p_rotation=1.0, p_scaling=1.0),
    "spatial_order1": lambda m: m.SpatialTransform(p_rotation=1.0, p_scaling=1.0, order_data=1),
    "spatial_rotate_only": lambda m: m.SpatialTransform(p_rotation=1.0, p_scaling=0.0,
                                                        order_data=1),
    "noise": lambda m: m.GaussianNoise(p=1.0),
    "blur": lambda m: m.GaussianBlur(p=1.0, p_per_channel=1.0),
    "brightness": lambda m: m.BrightnessMultiplicative(p=1.0),
    "contrast": lambda m: m.ContrastAugmentation(p=1.0),
    "low_resolution": lambda m: m.SimulateLowResolution(p=1.0, p_per_channel=1.0),
    "gamma": lambda m: m.GammaTransform(p=1.0),
    "gamma_inverted": lambda m: m.GammaTransform(p=1.0, invert_image=True),
    "mirror": lambda m: m.MirrorTransform(),
    "remove_label": lambda m: m.RemoveLabelTransform(),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name, native):
    want = TRANSFORMS[name](ja)(_sample(), np.random.RandomState(5))
    got = TRANSFORMS[name](ta)(_sample(), np.random.RandomState(5))
    _equal(got, want)


STACKS = ["get_train_transforms", "get_train_transforms_nomirror",
          "get_train_transforms_onlymirror", "get_train_transforms_onlyspatial",
          "get_train_transforms_noaug", "get_validation_transforms"]


@pytest.mark.parametrize("name", STACKS + ["fast"])
def test_stack_matches_jax(name, native):
    if name == "fast":
        tj, tt = ja.get_train_transforms(fast_spatial=True), ta.get_train_transforms(fast_spatial=True)
    else:
        tj, tt = getattr(ja, name)(), getattr(ta, name)()
    rj, rt = np.random.RandomState(11), np.random.RandomState(11)
    for i in range(4):  # several draws: each transform fires on some of them
        _equal(tt(_sample(i), rt), tj(_sample(i), rj))


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """Three preprocessed cases (one smaller than the patch) with class
    locations."""
    out = tmp_path_factory.mktemp("fullres")
    rng = np.random.default_rng(0)
    for i, shape in enumerate([(24, 26, 20), (18, 30, 22), (12, 14, 10)]):
        data = rng.standard_normal((2, *shape)).astype(np.float32)
        seg = np.zeros((1, *shape), np.int8)
        seg[0, 3:9, 4:10, 2:8] = 1
        seg[0, 5:7, 5:8, 3:6] = 3
        np.savez(out / f"case_{i}.npz", data=data, seg=seg)
        props = {"spacing": [1, 1, 1],
                 "class_locations": {1: np.argwhere(seg == 1), 3: np.argwhere(seg == 3),
                                     2: np.zeros((0, 4), np.int64)}}
        with open(out / f"case_{i}.pkl", "wb") as f:
            pickle.dump(props, f)
    return str(out)


NAMES = ["case_0", "case_1", "case_2"]


@pytest.mark.parametrize("batch,oversample", [(2, 0.33), (3, 1.0), (4, 0.0)])
def test_patch_sampler_matches_jax(tiny_tree, batch, oversample):
    kw = dict(patch_size=(16, 16, 16), batch_size=batch,
              oversample_foreground_percent=oversample, seed=3)
    sj = JaxSampler(JaxDataset(tiny_tree, NAMES, unpack=False), **kw)
    st = PatchSampler(MedicalDataset(tiny_tree, NAMES, unpack=False), **kw)
    for _ in range(3):
        bj, bt = sj.generate_batch(), st.generate_batch()
        assert np.array_equal(bt["data"], bj["data"]) and np.array_equal(bt["seg"], bj["seg"])
        assert bt["data"].shape == (batch, 2, 16, 16, 16)


@pytest.mark.parametrize("transform", ["train", "train_fast", "noaug", "val"])
def test_inline_loader_matches_jax(tiny_tree, transform, native):
    kw = dict(steps_per_epoch=3, patch_size=(16, 16, 16), batch_size=2, transform=transform,
              num_workers=0, seed=7)
    lj = JaxLoader(JaxDataset(tiny_tree, NAMES, unpack=False), **kw)
    lt = PrefetchLoader(MedicalDataset(tiny_tree, NAMES, unpack=False), **kw)
    got, want = list(lt), list(lj)
    assert len(got) == len(want) == 3
    for bt, bj in zip(got, want):
        _equal(bt, bj)
        assert bt["data"].shape == (2, 16, 16, 16, 2)  # channels-last
        assert bt["seg"].shape == (2, 16, 16, 16, 1)


def test_worker_loader_count_shapes_and_shutdown(tiny_tree):
    loader = PrefetchLoader(MedicalDataset(tiny_tree, NAMES, unpack=False), steps_per_epoch=5,
                            patch_size=(16, 16, 16), batch_size=2, transform="train_fast",
                            num_workers=2, cache_size=2, seed=1)
    try:
        for _ in range(2):  # two epochs from the same workers
            batches = list(loader)
            assert len(batches) == 5 == len(loader)
            for b in batches:
                assert b["data"].shape == (2, 16, 16, 16, 2) and b["data"].dtype == np.float32
                assert b["seg"].shape == (2, 16, 16, 16, 1)
                # integer labels, -1 removed (the spatial transform's linear
                # resample of the seg, rounded, can make a 2 between 1 and 3)
                assert set(np.unique(b["seg"])) <= {0.0, 1.0, 2.0, 3.0}
        procs = list(loader._procs)
        assert len(procs) == 2 and all(p.is_alive() for p in procs)
    finally:
        loader.shutdown()
    assert loader._procs == [] and not any(p.is_alive() for p in procs)


def test_runtime_builds_into_the_port(tmp_path):
    import os

    assert truntime.available()
    assert os.path.dirname(truntime._LIB_PATH).endswith(os.path.join("waveformer_tpu_torch",
                                                                     "_build"))
    vol = np.random.default_rng(0).standard_normal((6, 7, 8)).astype(np.float32)
    assert np.array_equal(truntime.gaussian_blur(vol, 0.8), jruntime.gaussian_blur(vol, 0.8))
    assert np.array_equal(truntime.crop_pad(vol[None], (-2, 1, 3), (5, 5, 5), -1.0),
                          jruntime.crop_pad(vol[None], (-2, 1, 3), (5, 5, 5), -1.0))
