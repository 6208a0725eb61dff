"""Preprocessed-case dataset + split factories.

Capability match for `light_training/dataloading/dataset.py`: cached `.pkl`
properties, one-time `.npz` → `.npy` unpacking, memory-mapped reads, and the
split factories (persisted default train/val split, pkl test list, k-fold,
explicit lists). Artifact layout is identical to the reference's so its
`data_list/*.pkl` splits load unchanged.

A copy of `waveformer_tpu/data/dataset.py`: the same seed gives the same
split lists as the JAX package.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _unpack_case(npz_path: str) -> None:
    base = npz_path[:-4]
    with np.load(npz_path) as z:
        for key in z.files:
            out = base + f"_{key}.npy" if key != "data" else base + ".npy"
            if key == "seg":
                out = base + "_seg.npy"
            if not os.path.exists(out):
                np.save(out, z[key])


def unpack_dataset(folder: str, num_processes: int = 8) -> None:
    """npz → npy once, so training reads are memory-mapped
    (`dataloading/utils.py:6-40`)."""
    npzs = [
        os.path.join(folder, f)
        for f in sorted(os.listdir(folder))
        if f.endswith(".npz")
    ]
    todo = [
        p for p in npzs
        if not (os.path.exists(p[:-4] + ".npy")
                and os.path.exists(p[:-4] + "_seg.npy"))
    ]
    if not todo:
        return
    if num_processes <= 1:
        for p in todo:
            _unpack_case(p)
        return
    with mp.get_context("spawn").Pool(num_processes) as pool:
        pool.map(_unpack_case, todo)


class MedicalDataset:
    """Memory-mapped preprocessed cases (`dataset.py:29-100` equivalent)."""

    def __init__(self, data_dir: str, case_names: Sequence[str],
                 unpack: bool = True, num_processes: int = 8):
        self.data_dir = data_dir
        self.case_names = list(case_names)
        if unpack:
            unpack_dataset(data_dir, num_processes)
        self._properties_cache: Dict[str, Dict] = {}

    def __len__(self) -> int:
        return len(self.case_names)

    def properties(self, name: str) -> Dict:
        if name not in self._properties_cache:
            with open(os.path.join(self.data_dir, name + ".pkl"), "rb") as f:
                self._properties_cache[name] = pickle.load(f)
        return self._properties_cache[name]

    def __getitem__(self, idx_or_name) -> Dict:
        name = (
            idx_or_name
            if isinstance(idx_or_name, str)
            else self.case_names[idx_or_name]
        )
        base = os.path.join(self.data_dir, name)
        if os.path.exists(base + ".npy"):
            data = np.load(base + ".npy", mmap_mode="r")
            seg_path = base + "_seg.npy"
            seg = (
                np.load(seg_path, mmap_mode="r")
                if os.path.exists(seg_path)
                else None
            )
        else:  # not yet unpacked: read the compressed artifact directly
            z = np.load(base + ".npz")
            data = z["data"]
            seg = z["seg"] if "seg" in z.files else None
        return {"data": data, "seg": seg, "properties": self.properties(name),
                "name": name}


def _all_cases(data_dir: str) -> List[str]:
    return sorted(
        f[:-4] for f in os.listdir(data_dir) if f.endswith(".npz")
    )


def _load_pkl_list(path: str) -> List[str]:
    with open(path, "rb") as f:
        return list(pickle.load(f))


def get_train_val_test_loader_from_train(
    data_dir: str,
    test_list_path: Optional[str] = None,
    split_dir: Optional[str] = None,
    val_fraction: float = 0.1,
    seed: int = 42,
    unpack: bool = True,
) -> Tuple[MedicalDataset, MedicalDataset, MedicalDataset]:
    """Reference `get_train_val_test_loader_from_train`
    (`dataset.py:253-307`): test cases from a pkl list; remaining cases split
    train/val, persisted to `{split_dir}/train_list.pkl` / `val_list.pkl` and
    reused on later runs."""
    all_cases = _all_cases(data_dir)
    test_cases: List[str] = []
    if test_list_path and os.path.exists(test_list_path):
        test_cases = [c for c in _load_pkl_list(test_list_path) if c in set(all_cases)]
    remaining = [c for c in all_cases if c not in set(test_cases)]

    train_cases: List[str]
    val_cases: List[str]
    if split_dir:
        tr_p = os.path.join(split_dir, "train_list.pkl")
        va_p = os.path.join(split_dir, "val_list.pkl")
        if os.path.exists(tr_p) and os.path.exists(va_p):
            train_cases = _load_pkl_list(tr_p)
            val_cases = _load_pkl_list(va_p)
        else:
            train_cases, val_cases = _split(remaining, val_fraction, seed)
            os.makedirs(split_dir, exist_ok=True)
            with open(tr_p, "wb") as f:
                pickle.dump(train_cases, f)
            with open(va_p, "wb") as f:
                pickle.dump(val_cases, f)
    else:
        train_cases, val_cases = _split(remaining, val_fraction, seed)

    mk = lambda names: MedicalDataset(data_dir, names, unpack=unpack)
    return mk(train_cases), mk(val_cases), mk(test_cases)


def _split(cases: List[str], val_fraction: float, seed: int):
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(cases))
    n_val = max(1, int(round(len(cases) * val_fraction))) if cases else 0
    val = [cases[i] for i in idx[:n_val]]
    train = [cases[i] for i in idx[n_val:]]
    return train, val


def get_kfold_loader(
    data_dir: str, fold: int = 0, n_folds: int = 5, seed: int = 42,
    unpack: bool = True,
) -> Tuple[MedicalDataset, MedicalDataset]:
    """K-fold split (`dataset.py:130-167` capability, no sklearn needed)."""
    cases = _all_cases(data_dir)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(cases))
    folds = np.array_split(idx, n_folds)
    val_idx = set(folds[fold].tolist())
    val = [cases[i] for i in sorted(val_idx)]
    train = [cases[i] for i in idx if i not in val_idx]
    return (
        MedicalDataset(data_dir, train, unpack=unpack),
        MedicalDataset(data_dir, val, unpack=unpack),
    )


def get_loader_from_lists(
    data_dir: str, train: Sequence[str], val: Sequence[str],
    test: Sequence[str] = (), unpack: bool = True,
):
    """Explicit split lists (json/pkl-split capability, `dataset.py:215-243`)."""
    mk = lambda names: MedicalDataset(data_dir, list(names), unpack=unpack)
    return mk(train), mk(val), mk(test)
