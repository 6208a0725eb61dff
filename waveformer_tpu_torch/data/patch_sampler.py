"""Foreground-oversampled patch cropper.

Capability match for `light_training/dataloading/base_data_loader.py:5-212`
(nnUNet `DataLoaderMultiProcess`): random-case selection, the
last-33%-of-batch foreground guarantee, class-location-guided bbox centering,
and zero-padding when the case is smaller than the patch.

A copy of `waveformer_tpu/data/patch_sampler.py`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class PatchSampler:
    """Produces (B, C, *patch) / (B, 1, *patch) numpy batches."""

    def __init__(
        self,
        dataset,
        patch_size: Sequence[int] = (128, 128, 128),
        batch_size: int = 2,
        oversample_foreground_percent: float = 0.33,
        seed: Optional[int] = None,
    ):
        self.dataset = dataset
        self.patch_size = tuple(int(p) for p in patch_size)
        self.batch_size = batch_size
        self.oversample = oversample_foreground_percent
        self.rng = np.random.RandomState(seed)

    # `_oversample_last_XX_percent` (`base_data_loader.py:137-141`)
    def _force_fg(self, sample_idx: int) -> bool:
        return not sample_idx < round(
            self.batch_size * (1 - self.oversample)
        )

    def get_bbox(
        self,
        data_shape: Sequence[int],
        force_fg: bool,
        class_locations: Optional[Dict],
    ) -> Tuple[list, list]:
        """Lower/upper patch corners (`base_data_loader.py:147-211`):
        padding-aware random bbox, or centered on a random voxel of a random
        present foreground class."""
        dim = len(data_shape)
        need_to_pad = [
            max(0, self.patch_size[d] - data_shape[d]) for d in range(dim)
        ]
        lbs = [-need_to_pad[d] // 2 for d in range(dim)]
        ubs = [
            data_shape[d] + need_to_pad[d] // 2 + need_to_pad[d] % 2
            - self.patch_size[d]
            for d in range(dim)
        ]
        selected_voxel = None
        if force_fg and class_locations:
            eligible = [
                k for k, v in class_locations.items() if len(v) > 0
            ]
            if eligible:
                cls = eligible[self.rng.choice(len(eligible))]
                voxels = class_locations[cls]
                selected_voxel = voxels[self.rng.choice(len(voxels))]
        if selected_voxel is not None:
            # voxel is (channel, z, y, x); center the patch on it
            bbox_lbs = [
                min(
                    max(lbs[d], int(selected_voxel[d + 1]) - self.patch_size[d] // 2),
                    ubs[d],
                )
                for d in range(dim)
            ]
        else:
            bbox_lbs = [
                self.rng.randint(lbs[d], ubs[d] + 1) for d in range(dim)
            ]
        bbox_ubs = [bbox_lbs[d] + self.patch_size[d] for d in range(dim)]
        return bbox_lbs, bbox_ubs

    def crop_patch(
        self, data: np.ndarray, seg: Optional[np.ndarray],
        bbox_lbs, bbox_ubs,
    ):
        """Extract the (possibly out-of-bounds) bbox with zero padding
        (`base_data_loader.py:94-128` semantics; seg padded with -1)."""
        dim = len(bbox_lbs)
        shape = data.shape[1:]
        valid_lbs = [max(0, bbox_lbs[d]) for d in range(dim)]
        valid_ubs = [min(shape[d], bbox_ubs[d]) for d in range(dim)]
        sl = (slice(None),) + tuple(
            slice(valid_lbs[d], valid_ubs[d]) for d in range(dim)
        )
        pad = [(0, 0)] + [
            (valid_lbs[d] - bbox_lbs[d], bbox_ubs[d] - valid_ubs[d])
            for d in range(dim)
        ]
        data_p = np.pad(np.asarray(data[sl], np.float32), pad)
        seg_p = None
        if seg is not None:
            seg_p = np.pad(
                np.asarray(seg[sl], np.float32), pad, constant_values=-1
            )
        return data_p, seg_p

    def generate_batch(self) -> Dict[str, np.ndarray]:
        """One (data, seg, properties) batch
        (`generate_train_batch`, `base_data_loader.py:39-128`)."""
        n = len(self.dataset)
        keys = self.rng.choice(n, self.batch_size, replace=True)
        datas, segs, props = [], [], []
        for j, key in enumerate(keys):
            item = self.dataset[int(key)]
            data, seg = item["data"], item["seg"]
            force_fg = self._force_fg(j)
            class_locs = item["properties"].get("class_locations")
            lbs, ubs = self.get_bbox(data.shape[1:], force_fg, class_locs)
            d, s = self.crop_patch(data, seg, lbs, ubs)
            datas.append(d)
            segs.append(s)
            props.append(item["properties"])
        batch = {
            "data": np.stack(datas),
            "properties": props,
        }
        if segs[0] is not None:
            batch["seg"] = np.stack(segs)
        return batch

    def __iter__(self):
        while True:
            yield self.generate_batch()
