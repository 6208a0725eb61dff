"""SSL whole-volume data plumbing: decathlon datalists + cached datasets.

Equivalents of the reference SSL pipeline (`self_supervised/data_utils.py:
30-139`), which loads five public CT datasets through MONAI:

* `load_decathlon_datalist`  — MONAI `monai/data/decathlon_datalist.py`
  semantics: read the dataset JSON, select a list key ("training"/
  "validation"), resolve relative paths against `base_dir`, normalize
  bare-path entries to `{"image": path}` dicts.
* `SSLVolumeDataset`         — whole-volume CT loading with the reference's
  transform chain (`data_utils.py:73-92`): load NIfTI → scale intensity
  range (a_min/a_max → b_min/b_max, clipped) → pad to at least the ROI →
  crop foreground to a k-divisible box. `cache_rate` caches that
  deterministic prefix in memory once (MONAI `CacheDataset` capability);
  `smart_cache_num` keeps a fixed-size rotating cache (`SmartCacheDataset`
  capability with replace_rate=1: each epoch the window advances).
* `SSLCropLoader`            — `RandSpatialCropSamplesd(num_samples)` +
  batching: yields (B, D, H, W, C) float32 crop batches for `SSLTrainer`,
  with a background prefetch thread so volume IO overlaps device compute.

A copy of `waveformer_tpu/data/ssl_data.py` that reads NIfTI through the
port's `utils/nifti.py`: the same files and seed give the same batches as
the JAX package. It imports no torch.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------- #
# decathlon datalist
# --------------------------------------------------------------------------- #


def load_decathlon_datalist(
    data_list_file_path: str,
    is_segmentation: bool = True,
    data_list_key: str = "training",
    base_dir: Optional[str] = None,
) -> List[Dict]:
    """Load a Medical-Segmentation-Decathlon-style dataset JSON.

    Matches MONAI's loader as used at `data_utils.py:48-66`: entries may be
    plain path strings or dicts; relative paths are joined to `base_dir`
    (default: the JSON's directory); string entries become
    `{"image": path}` (+ `{"label": ...}` untouched if present).
    """
    with open(data_list_file_path) as f:
        spec = json.load(f)
    if data_list_key not in spec:
        raise ValueError(
            f"data list key {data_list_key!r} not in {data_list_file_path} "
            f"(keys: {sorted(spec)})"
        )
    datalist = spec[data_list_key]
    if base_dir is None:
        base_dir = os.path.dirname(data_list_file_path)

    def _resolve(p):
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    out: List[Dict] = []
    for item in datalist:
        if isinstance(item, str):
            out.append({"image": _resolve(item)})
            continue
        if not isinstance(item, dict):
            raise ValueError(f"unsupported datalist entry: {item!r}")
        entry = dict(item)
        for key in ("image", "label"):
            if key in entry and isinstance(entry[key], str):
                entry[key] = _resolve(entry[key])
        if is_segmentation and "label" not in entry:
            raise ValueError(f"segmentation datalist entry missing label: {item!r}")
        out.append(entry)
    return out


# --------------------------------------------------------------------------- #
# whole-volume dataset with caching
# --------------------------------------------------------------------------- #


def scale_intensity_range(
    img: np.ndarray,
    a_min: float,
    a_max: float,
    b_min: float,
    b_max: float,
    clip: bool = True,
) -> np.ndarray:
    """MONAI `ScaleIntensityRanged` (`data_utils.py:78-80` usage)."""
    img = (img.astype(np.float32) - a_min) / (a_max - a_min)
    img = img * (b_max - b_min) + b_min
    if clip:
        img = np.clip(img, min(b_min, b_max), max(b_min, b_max))
    return img


def crop_foreground_k_divisible(
    vol: np.ndarray, k: Sequence[int], threshold: float = 0.0
) -> np.ndarray:
    """MONAI `CropForegroundd(..., k_divisible=roi)` capability
    (`data_utils.py:82`): tight bbox of voxels > threshold, expanded
    symmetrically to the next multiple of `k` per axis (zero-padded when
    the expansion exceeds the volume)."""
    fg = vol > threshold
    if not fg.any():
        bbox = [(0, s) for s in vol.shape]
    else:
        bbox = []
        for ax in range(vol.ndim):
            proj = fg.any(axis=tuple(i for i in range(vol.ndim) if i != ax))
            idx = np.where(proj)[0]
            bbox.append((int(idx[0]), int(idx[-1]) + 1))
    out_slices, pads = [], []
    for ax, (lo, hi) in enumerate(bbox):
        size = hi - lo
        target = max(int(np.ceil(size / k[ax])) * k[ax], k[ax])
        extra = target - size
        lo2 = lo - extra // 2
        hi2 = hi + (extra - extra // 2)
        pad_lo = max(0, -lo2)
        pad_hi = max(0, hi2 - vol.shape[ax])
        out_slices.append(slice(max(lo2, 0), min(hi2, vol.shape[ax])))
        pads.append((pad_lo, pad_hi))
    cropped = vol[tuple(out_slices)]
    if any(p != (0, 0) for p in pads):
        cropped = np.pad(cropped, pads)
    return cropped


@dataclass
class SSLVolumeDataset:
    """Whole-volume dataset over a decathlon datalist with optional caching.

    `cache_rate`: fraction of items eagerly transformed and kept in memory
    (CacheDataset). `smart_cache_num`: fixed-size rotating window instead
    (SmartCacheDataset, replace_rate 1.0 — call `advance()` per epoch).
    """

    datalist: Sequence[Dict]
    roi: Tuple[int, int, int] = (96, 96, 96)
    a_min: float = -1000.0
    a_max: float = 1000.0
    b_min: float = 0.0
    b_max: float = 1.0
    cache_rate: float = 0.0
    smart_cache_num: int = 0
    _cache: Dict[int, np.ndarray] = field(default_factory=dict, repr=False)
    _window_start: int = 0

    def __post_init__(self):
        if self.cache_rate and self.smart_cache_num:
            raise ValueError("use either cache_rate or smart_cache_num")
        n_eager = int(len(self.datalist) * self.cache_rate)
        for i in range(n_eager):
            self._cache[i] = self._load_transform(i)
        if self.smart_cache_num:
            for i in range(min(self.smart_cache_num, len(self.datalist))):
                self._cache[i] = self._load_transform(i)

    def __len__(self) -> int:
        return len(self.datalist)

    def _load_transform(self, i: int) -> np.ndarray:
        from waveformer_tpu_torch.utils import nifti

        path = self.datalist[i]["image"]
        img = nifti.load(path)
        vol = np.ascontiguousarray(img.data.T).astype(np.float32)  # (D,H,W)
        vol = scale_intensity_range(
            vol, self.a_min, self.a_max, self.b_min, self.b_max
        )
        # pad to at least the ROI (SpatialPadd): MONAI's symmetric pad puts
        # the odd leftover voxel at the END (data_utils.py:81 convention)
        pads = [
            ((r - s) // 2, r - s - (r - s) // 2) if s < r else (0, 0)
            for r, s in zip(self.roi, vol.shape)
        ]
        if any(p != (0, 0) for p in pads):
            vol = np.pad(vol, pads)
        return crop_foreground_k_divisible(vol, self.roi)

    def __getitem__(self, i: int) -> np.ndarray:
        if i in self._cache:
            return self._cache[i]
        return self._load_transform(i)

    def advance(self):
        """SmartCache epoch advance: slide the cached window by its size."""
        if not self.smart_cache_num:
            return
        n = len(self.datalist)
        self._window_start = (self._window_start + self.smart_cache_num) % n
        self._cache.clear()
        for j in range(min(self.smart_cache_num, n)):
            i = (self._window_start + j) % n
            self._cache[i] = self._load_transform(i)

    @property
    def cached_indices(self) -> List[int]:
        return sorted(self._cache)


# --------------------------------------------------------------------------- #
# random-crop batch loader
# --------------------------------------------------------------------------- #


class SSLCropLoader:
    """Random spatial crop sampler over an `SSLVolumeDataset`
    (`RandSpatialCropSamplesd(num_samples=sw_batch)` + DataLoader batching,
    `data_utils.py:83-90,130-133`). Yields (B, D, H, W, 1) float32 batches
    with a one-deep background prefetch thread."""

    def __init__(
        self,
        dataset: SSLVolumeDataset,
        batch_size: int = 2,
        num_samples: int = 2,
        num_steps: int = 100,
        seed: int = 0,
        prefetch: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.num_steps = num_steps
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def _crop(self, vol: np.ndarray) -> np.ndarray:
        r = self.dataset.roi
        starts = [
            self.rng.integers(0, max(s - rr, 0) + 1)
            for s, rr in zip(vol.shape, r)
        ]
        return vol[
            starts[0] : starts[0] + r[0],
            starts[1] : starts[1] + r[1],
            starts[2] : starts[2] + r[2],
        ]

    def _make_batch(self) -> np.ndarray:
        crops = []
        while len(crops) < self.batch_size:
            i = int(self.rng.integers(0, len(self.dataset)))
            vol = self.dataset[i]
            for _ in range(self.num_samples):
                if len(crops) == self.batch_size:
                    break
                crops.append(self._crop(vol))
        return np.stack(crops)[..., None].astype(np.float32)

    def __iter__(self) -> Iterator[np.ndarray]:
        if not self.prefetch:
            for _ in range(self.num_steps):
                yield self._make_batch()
            return

        q: "queue.Queue" = queue.Queue(maxsize=2)

        def worker():
            try:
                for _ in range(self.num_steps):
                    q.put(self._make_batch())
                q.put(None)
            except BaseException as e:  # surface worker failures
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
