"""Dataset variants: global-context channel and SDM/edge supervision maps.

Capability match for the reference's off-main-path loaders
(`light_training/dataloading_global/dataset.py:26` — a whole-volume,
downsampled context volume alongside each patch case — and
`light_training/dataloading/dataset_sdm_edge.py` — signed-distance-map and
boundary-edge targets derived from the segmentation, for boundary-aware
losses). Both wrap `MedicalDataset` and add keys to the item dict; custom
`Trainer.training_loss` hooks consume them.

A copy of `waveformer_tpu/data/dataset_variants.py` over the port's own
`data/dataset.py::MedicalDataset` (numpy/scipy, no torch).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from waveformer_tpu_torch.data.dataset import MedicalDataset


class GlobalContextDataset:
    """Adds `data_global`: the full volume resampled to a fixed (coarse)
    shape — global anatomical context for patch-based training.

    When the dataset was preprocessed by `GlobalContextPreprocessor`
    (`python -m waveformer_tpu_torch.scripts.preprocess --dataset-type
    mri-global`), the precomputed context
    is read straight from the stored artifact — `{case}_data_global.npy`
    (unpacked, memory-mapped) or the `data_global` key in `{case}.npz` —
    with no recomputation; otherwise it is derived on the fly from the
    full-resolution volume (and memoized)."""

    def __init__(
        self,
        base: MedicalDataset,
        global_shape: Sequence[int] = (64, 64, 64),
        order: int = 1,
    ):
        self.base = base
        self.global_shape = tuple(int(s) for s in global_shape)
        self.order = order
        self._cache: Dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.base)

    @property
    def data_dir(self):
        return self.base.data_dir

    @property
    def case_names(self):
        return self.base.case_names

    def _precomputed(self, name: str):
        import os

        base = os.path.join(self.base.data_dir, name)
        npy = base + "_data_global.npy"
        if os.path.exists(npy):
            return np.load(npy, mmap_mode="r")
        npz = base + ".npz"
        if os.path.exists(npz):
            with np.load(npz) as z:
                if "data_global" in z.files:
                    return z["data_global"]
        return None

    def _global(self, name: str, data: np.ndarray) -> np.ndarray:
        if name not in self._cache:
            pre = self._precomputed(name)
            if pre is not None:
                self._cache[name] = pre
            else:
                from scipy import ndimage

                zoom = [1.0] + [
                    t / s for t, s in zip(self.global_shape, data.shape[1:])
                ]
                self._cache[name] = ndimage.zoom(
                    np.asarray(data, np.float32), zoom, order=self.order
                ).astype(np.float32)
        return self._cache[name]

    def __getitem__(self, idx_or_name) -> Dict:
        item = dict(self.base[idx_or_name])
        item["data_global"] = self._global(item["name"], item["data"])
        return item


def signed_distance_map(
    seg: np.ndarray, spacing: Sequence[float] = (1.0, 1.0, 1.0),
    normalize: bool = True,
) -> np.ndarray:
    """SDM of a binary mask: negative inside, positive outside (the
    convention of boundary-loss literature); optionally normalized to
    [-1, 1] per region."""
    from scipy import ndimage

    seg = np.asarray(seg).astype(bool)
    if not seg.any() or seg.all():
        return np.zeros(seg.shape, np.float32)
    dist_out = ndimage.distance_transform_edt(~seg, sampling=spacing)
    dist_in = ndimage.distance_transform_edt(seg, sampling=spacing)
    if normalize:
        dist_out = dist_out / max(dist_out.max(), 1e-8)
        dist_in = dist_in / max(dist_in.max(), 1e-8)
    return (dist_out - dist_in).astype(np.float32)


def edge_map(seg: np.ndarray) -> np.ndarray:
    """Binary boundary of a label map (6-connectivity erosion residue)."""
    from scipy import ndimage

    seg = np.asarray(seg) > 0
    if not seg.any():
        return np.zeros(seg.shape, np.float32)
    structure = ndimage.generate_binary_structure(seg.ndim, 1)
    eroded = ndimage.binary_erosion(seg, structure=structure, border_value=1)
    return (seg & ~eroded).astype(np.float32)


class SDMEdgeDataset:
    """Adds `seg_sdm` (per-foreground-class signed distance maps) and
    `seg_edge` (boundary map) derived from the stored segmentation."""

    def __init__(
        self,
        base: MedicalDataset,
        foreground_classes: Sequence[int] = (1, 2, 3),
    ):
        self.base = base
        self.foreground_classes = tuple(foreground_classes)

    def __len__(self):
        return len(self.base)

    @property
    def data_dir(self):
        return self.base.data_dir

    @property
    def case_names(self):
        return self.base.case_names

    def __getitem__(self, idx_or_name) -> Dict:
        item = dict(self.base[idx_or_name])
        seg = np.asarray(item["seg"][0])
        props = item["properties"]
        spacing = props.get("target_spacing_trans", (1.0, 1.0, 1.0))
        sdms = np.stack(
            [signed_distance_map(seg == c, spacing) for c in self.foreground_classes]
        )
        item["seg_sdm"] = sdms
        item["seg_edge"] = edge_map(seg)[None]
        return item
