"""Multiprocess prefetching batch pipeline.

Capability match for the reference's augmentation loader
(`LimitedLenWrapper(NonDetMultiThreadedAugmenter)`,
`light_training/augment/multi_processor.py:4-9`, wired at
`light_training/trainer.py:131-176`): N worker processes each crop
fg-oversampled patches and run the augmentation stack, pushing finished
numpy batches into a bounded queue the training loop drains. Host
augmentation overlaps device compute (double-buffered by the queue).

Batches come out channels-LAST ((B, D, H, W, C)) numpy arrays, as in the
JAX package; the trainer uploads them. A copy of
`waveformer_tpu/data/pipeline.py`: the workers import only the port's
numpy modules and never touch torch or CUDA.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
from typing import Dict, Iterator, List, Optional

import numpy as np

from waveformer_tpu_torch.data import augment as aug


_TRANSFORMS = {
    "train": aug.get_train_transforms,
    # native OpenMP order-1 spatial resample instead of scipy order-3:
    # ~10× faster per worker, augmentation-quality impact negligible
    "train_fast": lambda: aug.get_train_transforms(fast_spatial=True),
    "nomirror": aug.get_train_transforms_nomirror,
    "onlymirror": aug.get_train_transforms_onlymirror,
    "onlyspatial": aug.get_train_transforms_onlyspatial,
    "noaug": aug.get_train_transforms_noaug,
    "val": aug.get_validation_transforms,
}


def _make_batch(sampler, transform, rng) -> Dict[str, np.ndarray]:
    raw = sampler.generate_batch()
    datas, segs = [], []
    for i in range(raw["data"].shape[0]):
        sample = {"data": raw["data"][i]}
        if "seg" in raw:
            sample["seg"] = raw["seg"][i]
        sample = transform(sample, rng)
        datas.append(sample["data"])
        if sample.get("seg") is not None:
            segs.append(sample["seg"])
    out = {"data": np.stack(datas).transpose(0, 2, 3, 4, 1)}  # → channels-last
    if segs:
        out["seg"] = np.stack(segs).transpose(0, 2, 3, 4, 1)
    return out


def _worker_loop(
    data_dir: str,
    case_names: List[str],
    patch_size,
    batch_size: int,
    oversample: float,
    transform_name: str,
    seed: int,
    out_queue: mp.Queue,
    stop_event,
):
    from waveformer_tpu_torch.data.dataset import MedicalDataset
    from waveformer_tpu_torch.data.patch_sampler import PatchSampler

    ds = MedicalDataset(data_dir, case_names, unpack=False)
    sampler = PatchSampler(
        ds, patch_size=patch_size, batch_size=batch_size,
        oversample_foreground_percent=oversample, seed=seed,
    )
    transform = _TRANSFORMS[transform_name]()
    rng = np.random.RandomState(seed + 10007)
    while not stop_event.is_set():
        batch = _make_batch(sampler, transform, rng)
        while not stop_event.is_set():
            try:
                out_queue.put(batch, timeout=0.5)
                break
            except queue_mod.Full:
                continue


class PrefetchLoader:
    """Bounded-length iterable of augmented batches.

    `num_workers=0` runs inline (deterministic, used by tests); otherwise
    spawn processes keep `cache_size` batches ready (reference defaults:
    12 workers, 6 cached — `trainer.py:161-164`).
    """

    def __init__(
        self,
        dataset,
        steps_per_epoch: int,
        patch_size=(128, 128, 128),
        batch_size: int = 2,
        oversample_foreground_percent: float = 0.33,
        transform: str = "train",
        num_workers: int = 12,
        cache_size: int = 6,
        seed: int = 42,
    ):
        self.dataset = dataset
        self.steps_per_epoch = steps_per_epoch
        self.patch_size = tuple(patch_size)
        self.batch_size = batch_size
        self.oversample = oversample_foreground_percent
        self.transform_name = transform
        self.num_workers = num_workers
        self.cache_size = cache_size
        self.seed = seed
        self._procs: List[mp.Process] = []
        self._queue: Optional[mp.Queue] = None
        self._stop = None

    def __len__(self):
        return self.steps_per_epoch

    # ---------------- worker management ---------------- #
    def start(self):
        if self.num_workers == 0 or self._procs:
            return
        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue(maxsize=self.cache_size)
        self._stop = ctx.Event()
        for w in range(self.num_workers):
            p = ctx.Process(
                target=_worker_loop,
                args=(
                    self.dataset.data_dir,
                    self.dataset.case_names,
                    self.patch_size,
                    self.batch_size,
                    self.oversample,
                    self.transform_name,
                    self.seed + w,
                    self._queue,
                    self._stop,
                ),
                daemon=True,
            )
            p.start()
            self._procs.append(p)

    def shutdown(self):
        if self._stop is not None:
            self._stop.set()
        for p in self._procs:
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
        self._procs = []
        self._queue = None

    def _check_workers(self):
        """Worker-death detection (`default_preprocessor.py:516-524` analog)."""
        for p in self._procs:
            if not p.is_alive() and p.exitcode not in (0, None):
                raise RuntimeError(
                    f"data worker died with exit code {p.exitcode} "
                    "(out of memory? reduce num_workers/cache_size)"
                )

    # ---------------- iteration ---------------- #
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers == 0:
            from waveformer_tpu_torch.data.patch_sampler import PatchSampler

            sampler = PatchSampler(
                self.dataset, patch_size=self.patch_size,
                batch_size=self.batch_size,
                oversample_foreground_percent=self.oversample, seed=self.seed,
            )
            transform = _TRANSFORMS[self.transform_name]()
            rng = np.random.RandomState(self.seed + 10007)
            for _ in range(self.steps_per_epoch):
                yield _make_batch(sampler, transform, rng)
            return

        self.start()
        for _ in range(self.steps_per_epoch):
            while True:
                self._check_workers()
                try:
                    yield self._queue.get(timeout=5.0)
                    break
                except queue_mod.Empty:
                    continue
