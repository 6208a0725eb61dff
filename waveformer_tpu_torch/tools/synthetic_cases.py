"""Seeded BraTS-style cases as preprocessing leaves them, for the serving
scripts (`scripts/predict.py`, `scripts/compute_metrics.py`) and training
(`scripts/train.py`).

`write_cases(root, rng, ...)` writes, under `root`:
  * `raw/{case}/seg.nii.gz`: a tumour-like label map (label 3 core, 1 body,
    2 shell) in source voxel order under `affine`;
  * `fullres/{case}.npz` (`data` (4, D, H, W) fp32, `seg` (1, D, H, W)
    int8, the crop's labels where the case is stored at its crop), unpacked to
    `.npy`, and `fullres/{case}.pkl` with the properties preprocessing
    records (`spacing`, `shape_before_cropping`, `bbox_used_for_cropping`,
    `shape_after_cropping_and_before_resampling`, `orientation`,
    `source_affine`), the orientation made with `nifti.as_canonical` as the
    JAX package's preprocessing makes it;
  * `data_list/test_list.pkl` naming every case.

`write_checkpoint(path, network_kwargs)` writes a seeded model's
parameters as a params `.npz` in the JAX package's format.

`write_raw_cases(raw_dir, rng, shape, affine, n)` writes raw cases as the
BraTS download names them, for the front end (`scripts/rename_data.py`,
`scripts/preprocess.py`, `deploy/process.py`).

`write_training_cases(fullres, n, shape)` writes preprocessed training
cases as `tools/bench_train.py::make_cases` makes them: (4, *shape) fp32
data, an int8 seg with classes 1-3 in three boxes, and a `.pkl` with
`class_locations` (the patch sampler's foreground oversampling reads it),
unpacked to `.npy`.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from waveformer_tpu_torch.data.dataset import unpack_dataset
from waveformer_tpu_torch.training.checkpoint import save_params_npz
from waveformer_tpu_torch.utils import nifti
from waveformer_tpu_torch.utils.torch_port import convert_state_dict

Box = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def tumour_labels(shape: Sequence[int], radius: float) -> np.ndarray:
    """Concentric label map centred in `shape`: 3 inside radius/3, 1 inside
    2·radius/3, 2 inside radius, 0 elsewhere."""
    grid = np.ogrid[tuple(slice(0, n) for n in shape)]
    r2 = sum((g - n // 2) ** 2 for g, n in zip(grid, shape))
    return np.select([r2 < (radius / 3) ** 2, r2 < (2 * radius / 3) ** 2, r2 < radius**2],
                     [3, 1, 2], 0).astype(np.uint8)


def write_cases(
    root: str,
    rng: np.random.Generator,
    raw_shape: Tuple[int, int, int],
    bboxes: Sequence[Box],
    affine: np.ndarray,
    stored_shapes: Optional[Sequence[Tuple[int, int, int]]] = None,
) -> List[str]:
    """One case per bbox (a crop of the canonical (D, H, W) volume); case i
    is stored at `stored_shapes[i]` (default: its crop), as resampling
    would leave it. Returns the case names."""
    fullres = os.path.join(root, "fullres")
    os.makedirs(fullres)
    os.makedirs(os.path.join(root, "data_list"))
    names = []
    for i, bbox in enumerate(bboxes):
        name = f"BraTS-GLI-{i:05d}-000"
        names.append(name)
        can, ornt = nifti.as_canonical(
            nifti.NiftiImage(data=np.zeros(raw_shape, np.uint8), affine=affine))
        full = can.data.T.shape  # canonical (D, H, W)
        crop = tuple(slice(b0, b1) for b0, b1 in bbox)
        crop_shape = tuple(b1 - b0 for b0, b1 in bbox)
        seg = np.zeros(full, np.uint8)
        seg[crop] = tumour_labels(crop_shape, min(crop_shape) / 4)
        os.makedirs(os.path.join(root, "raw", name))
        nifti.save(nifti.NiftiImage(data=nifti.undo_canonical(seg.T, ornt), affine=affine),
                   os.path.join(root, "raw", name, "seg.nii.gz"))
        stored = tuple(stored_shapes[i]) if stored_shapes else crop_shape
        data = rng.standard_normal((4, *stored)).astype(np.float32)
        stored_seg = np.zeros((1, *stored), np.int8)  # resampled cases: no labels
        if stored == crop_shape:
            data += (seg[crop] > 0)[None]
            stored_seg[0] = seg[crop]
        np.savez(os.path.join(fullres, name + ".npz"), data=data, seg=stored_seg)
        props: Dict = {
            "spacing": list(can.spacing[::-1]),
            "shape_before_cropping": full,
            "bbox_used_for_cropping": [list(b) for b in bbox],
            "shape_after_cropping_and_before_resampling": crop_shape,
            "source_affine": np.asarray(affine, float).tolist(),
            "orientation": np.asarray(ornt, float).tolist(),
        }
        with open(os.path.join(fullres, name + ".pkl"), "wb") as f:
            pickle.dump(props, f)
    with open(os.path.join(root, "data_list", "test_list.pkl"), "wb") as f:
        pickle.dump(names, f)
    unpack_dataset(fullres, num_processes=1)
    return names


BRATS_MODALITIES = ("t2w", "t2f", "t1n", "t1c")


def write_raw_cases(
    raw_dir: str,
    rng: np.random.Generator,
    shape: Tuple[int, int, int],
    affine: np.ndarray,
    n: int,
    margin: Sequence[int] = (3, 3, 2),
) -> List[str]:
    """`n` raw cases `BraTS-GLI-{i:05d}-000/BraTS-GLI-{i:05d}-000-{t2w,t2f,
    t1n,t1c,seg}.nii.gz` under `raw_dir`: (X, Y, Z) = `shape` volumes under
    `affine`. The four fp32 modalities are nonzero only inside an
    ellipsoid "brain" that keeps `margin` voxels (per axis, on each side)
    from the volume's faces, so preprocessing's crop is real and its
    corners lie outside the mask. The uint8 seg holds a tumour
    (`tumour_labels`: 3 core, 1 body, 2 shell) at a seeded position inside
    the brain, brighter in every modality. Returns the case names."""
    grid = np.ogrid[tuple(slice(0, s) for s in shape)]
    centre = [(s - 1) / 2 for s in shape]
    semi = [(s - 1) / 2 - m for s, m in zip(shape, margin)]
    brain = sum(((g - c) / a) ** 2 for g, c, a in zip(grid, centre, semi)) < 1.0
    radius = max(2, int(min(semi) / 3))
    names = []
    for i in range(n):
        name = f"BraTS-GLI-{i:05d}-000"
        case_dir = os.path.join(raw_dir, name)
        os.makedirs(case_dir)
        at = [int(c + rng.integers(-a // 4, a // 4 + 1)) for c, a in zip(centre, semi)]
        seg = np.zeros(shape, np.uint8)
        box = tuple(slice(a - radius, a + radius + 1) for a in at)
        seg[box] = tumour_labels((2 * radius + 1,) * 3, radius)
        seg[~brain] = 0
        for k, mod in enumerate(BRATS_MODALITIES):
            vol = rng.standard_normal(shape, dtype=np.float32) + np.float32(2 + k)
            vol += seg > 0
            vol[~brain] = 0.0
            nifti.save(nifti.NiftiImage(data=vol, affine=affine),
                       os.path.join(case_dir, f"{name}-{mod}.nii.gz"))
        nifti.save(nifti.NiftiImage(data=seg, affine=affine),
                   os.path.join(case_dir, f"{name}-seg.nii.gz"))
        names.append(name)
    return names


def write_checkpoint(path: str, network_kwargs: Dict, seed: int = 0) -> None:
    """The seed-`seed` model of `network_kwargs` (built on the CPU in fp32)
    as a params `.npz`, as JAX training writes `best_model_*.npz`."""
    from waveformer_tpu_torch.models import create_waveformer

    model = create_waveformer(network_kwargs, device="cpu", seed=seed)
    params = convert_state_dict(model.state_dict(),
                                depths=tuple(network_kwargs.get("depths", (2, 2, 2, 2))),
                                hf_refinement=bool(network_kwargs.get("hf_refinement", False)))
    save_params_npz(params, path)


def write_training_cases(fullres: str, n: int = 4,
                         shape: Tuple[int, int, int] = (150, 180, 145),
                         seed: int = 0) -> List[str]:
    """`n` preprocessed BraTS-sized training cases `case_{i}` under
    `fullres`, their label boxes where `tools/bench_train.py::make_cases`
    places them at (150, 180, 145) and scaled with the shape at any other.
    Returns the case names."""
    os.makedirs(fullres, exist_ok=True)
    rng = np.random.default_rng(seed)

    def box(*corners):
        return (0,) + tuple(slice(a * s // s0, b * s // s0)
                            for (a, b), s, s0 in zip(corners, shape, (150, 180, 145)))

    names = []
    for i in range(n):
        data = rng.standard_normal((4, *shape)).astype(np.float32)
        seg = np.zeros((1, *shape), np.int8)
        seg[box((40, 90), (50, 100), (40, 80))] = 1
        seg[box((55, 70), (60, 80), (50, 65))] = 3
        seg[box((45, 60), (80, 95), (60, 75))] = 2
        name = f"case_{i}"
        np.savez(os.path.join(fullres, name + ".npz"), data=data, seg=seg)
        props = {
            "spacing": [1.0, 1.0, 1.0],
            "class_locations": {c: np.argwhere(seg == c)[:2000] for c in (1, 2, 3)},
            "shape_before_cropping": tuple(shape),
            "bbox_used_for_cropping": [[0, s] for s in shape],
            "shape_after_cropping_before_resample": tuple(shape),
        }
        with open(os.path.join(fullres, name + ".pkl"), "wb") as f:
            pickle.dump(props, f)
        names.append(name)
    unpack_dataset(fullres, num_processes=1)
    return names
