"""The port's dataset and split factories against the JAX package's, on a
temporary preprocessed folder: the same seed gives the same lists, a split
persisted by either package is reused by the other, and the items (data,
seg, properties, name) are equal, read packed or unpacked.
"""

import os
import pickle

import numpy as np
import pytest

from waveformer_tpu.data import dataset as jd
from waveformer_tpu_torch.data import dataset as td

N_CASES = 11


def _folder(root):
    rng = np.random.default_rng(4)
    names = [f"case_{i:03d}" for i in rng.permutation(N_CASES)]
    for name in names:
        np.savez(os.path.join(root, name + ".npz"),
                 data=rng.standard_normal((2, 4, 5, 3)).astype(np.float32),
                 seg=rng.integers(0, 3, (1, 4, 5, 3)).astype(np.int8))
        with open(os.path.join(root, name + ".pkl"), "wb") as f:
            pickle.dump({"spacing": [1.0, 1.0, 1.0], "name": name}, f)
    return sorted(names)


def _names(*datasets):
    return [ds.case_names for ds in datasets]


def _assert_items_equal(got_ds, want_ds):
    assert len(got_ds) == len(want_ds)
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        assert got["name"] == want["name"] and got["properties"] == want["properties"]
        np.testing.assert_array_equal(got["data"], want["data"])
        np.testing.assert_array_equal(got["seg"], want["seg"])


@pytest.mark.parametrize("seed,fraction", [(42, 0.1), (7, 0.3)])
def test_train_val_test_split_matches_jax(tmp_path, seed, fraction):
    root = str(tmp_path / "fullres")
    os.makedirs(root)
    names = _folder(root)
    test_list = str(tmp_path / "test_list.pkl")
    with open(test_list, "wb") as f:
        pickle.dump(names[:3] + ["not_in_folder"], f)
    kw = dict(test_list_path=test_list, val_fraction=fraction, seed=seed, unpack=False)
    got = td.get_train_val_test_loader_from_train(root, **kw)
    want = jd.get_train_val_test_loader_from_train(root, **kw)
    assert _names(*got) == _names(*want)
    assert _names(got[2]) == [names[:3]]
    for g, w in zip(got, want):
        _assert_items_equal(g, w)


def test_persisted_split_is_reused_across_packages(tmp_path):
    root = str(tmp_path / "fullres")
    os.makedirs(root)
    _folder(root)
    split_port = str(tmp_path / "split_port")
    split_jax = str(tmp_path / "split_jax")
    got = td.get_train_val_test_loader_from_train(root, split_dir=split_port, unpack=False)
    want = jd.get_train_val_test_loader_from_train(root, split_dir=split_jax, unpack=False)
    assert _names(*got) == _names(*want)
    for name in ("train_list.pkl", "val_list.pkl"):
        with open(os.path.join(split_port, name), "rb") as f, \
                open(os.path.join(split_jax, name), "rb") as g:
            assert pickle.load(f) == pickle.load(g)
    # a persisted split wins over the seed, in either package's hands
    with open(os.path.join(split_port, "val_list.pkl"), "wb") as f:
        pickle.dump(["case_000"], f)
    a = td.get_train_val_test_loader_from_train(root, split_dir=split_port, seed=1, unpack=False)
    b = jd.get_train_val_test_loader_from_train(root, split_dir=split_port, seed=1, unpack=False)
    assert _names(*a) == _names(*b)
    assert a[1].case_names == ["case_000"]


@pytest.mark.parametrize("fold", range(3))
def test_kfold_and_lists_match_jax(tmp_path, fold):
    root = str(tmp_path)
    names = _folder(root)
    got = td.get_kfold_loader(root, fold=fold, n_folds=3, seed=5, unpack=False)
    want = jd.get_kfold_loader(root, fold=fold, n_folds=3, seed=5, unpack=False)
    assert _names(*got) == _names(*want)
    lists = (names[:4], names[4:6], names[6:])
    assert _names(*td.get_loader_from_lists(root, *lists, unpack=False)) == \
        _names(*jd.get_loader_from_lists(root, *lists, unpack=False))


def test_unpacked_items_match_jax(tmp_path):
    root = str(tmp_path)
    names = _folder(root)
    packed = jd.MedicalDataset(root, names, unpack=False)
    td.unpack_dataset(root, num_processes=1)
    assert all(os.path.exists(os.path.join(root, n + suffix))
               for n in names for suffix in (".npy", "_seg.npy"))
    got = td.MedicalDataset(root, names, unpack=True, num_processes=1)
    want = jd.MedicalDataset(root, names, unpack=False)
    assert isinstance(got[0]["data"], np.memmap)
    _assert_items_equal(got, want)
    _assert_items_equal(got, packed)
    assert got["case_001"]["name"] == "case_001"
