"""Training augmentation stacks (host numpy/scipy).

Capability match for `light_training/augment/train_augment.py:23-236`
(batchgenerators-based nnUNet stack): spatial rotation ±30° / scaling
0.7–1.4, Gaussian noise/blur, multiplicative brightness, contrast,
simulated low-resolution, double gamma, mirroring, RemoveLabel(-1→0) — with
the reference's probabilities — plus the nomirror / onlymirror /
onlyspatial / noaug variants and validation transforms.

Transforms operate on a single sample dict {"data": (C, D, H, W),
"seg": (1, D, H, W)} in float32; they are designed to run in prefetch worker
processes (see `waveformer_tpu_torch.data.pipeline`).

A copy of `waveformer_tpu/data/augment.py`: for one `RandomState` seed
every transform gives the JAX package's arrays.
"""

from __future__ import annotations

import functools

from typing import Callable, Dict, Sequence, Tuple

import numpy as np

Sample = Dict[str, np.ndarray]


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample, rng: np.random.RandomState) -> Sample:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class SpatialTransform:
    """Rotation (±30° per axis) + isotropic scaling (0.7–1.4), each applied
    with its own per-sample probability (`train_augment.py:27-40` numbers)."""

    def __init__(
        self,
        p_rotation: float = 0.2,
        p_scaling: float = 0.2,
        angle_range: float = np.deg2rad(30.0),
        scale_range: Tuple[float, float] = (0.7, 1.4),
        order_data: int = 3,
        order_seg: int = 1,
    ):
        self.p_rotation = p_rotation
        self.p_scaling = p_scaling
        self.angle_range = angle_range
        self.scale_range = scale_range
        self.order_data = order_data
        self.order_seg = order_seg

    @staticmethod
    def _rotation_matrix(angles: np.ndarray) -> np.ndarray:
        ax, ay, az = angles
        rx = np.array(
            [[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]]
        )
        ry = np.array(
            [[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]]
        )
        rz = np.array(
            [[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]]
        )
        return rx @ ry @ rz

    def __call__(self, sample: Sample, rng: np.random.RandomState) -> Sample:
        do_rot = rng.uniform() < self.p_rotation
        do_scale = rng.uniform() < self.p_scaling
        if not (do_rot or do_scale):
            return sample
        mat = np.eye(3)
        if do_rot:
            angles = rng.uniform(-self.angle_range, self.angle_range, 3)
            mat = mat @ self._rotation_matrix(angles)
        if do_scale:
            mat = mat * rng.uniform(*self.scale_range)
        data = sample["data"]
        center = (np.asarray(data.shape[1:]) - 1) / 2.0
        offset = center - mat @ center
        out = np.empty_like(data)
        for c in range(data.shape[0]):
            out[c] = _affine(data[c], mat, offset, self.order_data, 0.0)
        sample = dict(sample)
        sample["data"] = out
        if sample.get("seg") is not None:
            seg = sample["seg"]
            seg_out = np.empty_like(seg)
            for c in range(seg.shape[0]):
                seg_out[c] = _affine(
                    seg[c], mat, offset, min(self.order_seg, 1), -1.0
                )
            sample["seg"] = np.round(seg_out)
        return sample


def _affine(vol, mat, offset, order, cval):
    """Native OpenMP affine resampling when available (orders 0/1);
    scipy spline for higher orders."""
    if order <= 1:
        from waveformer_tpu_torch import runtime

        return runtime.affine_transform(vol, mat, offset, order=order,
                                        cval=cval)
    from scipy import ndimage

    return ndimage.affine_transform(
        vol, mat, offset=offset, order=order, mode="constant", cval=cval
    ).astype(np.float32)


class GaussianNoise:
    def __init__(self, p: float = 0.1, variance: Tuple[float, float] = (0.0, 0.1)):
        self.p = p
        self.variance = variance

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        var = rng.uniform(*self.variance)
        sample = dict(sample)
        sample["data"] = sample["data"] + rng.normal(
            0, np.sqrt(var), sample["data"].shape
        ).astype(np.float32)
        return sample


class GaussianBlur:
    def __init__(self, p: float = 0.2, sigma: Tuple[float, float] = (0.5, 1.0),
                 p_per_channel: float = 0.5):
        self.p = p
        self.sigma = sigma
        self.p_per_channel = p_per_channel

    def __call__(self, sample, rng):
        from waveformer_tpu_torch import runtime

        if rng.uniform() >= self.p:
            return sample
        sample = dict(sample)
        data = sample["data"].copy()
        for c in range(data.shape[0]):
            if rng.uniform() < self.p_per_channel:
                data[c] = runtime.gaussian_blur(
                    data[c], rng.uniform(*self.sigma)
                )
        sample["data"] = data
        return sample


class BrightnessMultiplicative:
    def __init__(self, p: float = 0.15, rng_range: Tuple[float, float] = (0.75, 1.25)):
        self.p = p
        self.range = rng_range

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        sample = dict(sample)
        sample["data"] = sample["data"] * rng.uniform(*self.range)
        return sample


class ContrastAugmentation:
    def __init__(self, p: float = 0.15, rng_range: Tuple[float, float] = (0.75, 1.25)):
        self.p = p
        self.range = rng_range

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        sample = dict(sample)
        data = sample["data"].copy()
        factor = rng.uniform(*self.range)
        for c in range(data.shape[0]):
            mean = data[c].mean()
            mn, mx = data[c].min(), data[c].max()
            data[c] = np.clip((data[c] - mean) * factor + mean, mn, mx)
        sample["data"] = data
        return sample


@functools.lru_cache(maxsize=None)
def _zoom1d_matrix(n_in: int, n_out: int, order: int) -> np.ndarray:
    """(n_in, n_out) matrix of scipy `ndimage.zoom` along ONE axis.

    Built by zooming the identity's rows, so it encodes scipy's exact
    spline prefilter + boundary handling by construction. The 3D
    tensor-product spline zoom factors into per-axis 1D operators
    (evaluation and prefilter matrices on different axes commute), so
    applying these per axis reproduces `ndimage.zoom(vol, ..., order)` to
    fp tolerance at a fraction of the cost: 3 small GEMMs and 12 effective
    taps/voxel instead of map_coordinates' 64 gathered taps (measured
    2.7 s → 0.1 s for the order-3 up-zoom of a 128³ channel)."""
    from scipy import ndimage

    eye = np.eye(n_in, dtype=np.float64)
    m = ndimage.zoom(eye, (1.0, n_out / n_in), order=order)
    assert m.shape == (n_in, n_out), (m.shape, n_in, n_out)
    return np.ascontiguousarray(m, dtype=np.float32)


def _separable_zoom(vol: np.ndarray, out_shape: Tuple[int, ...],
                    order: int) -> np.ndarray:
    """scipy `ndimage.zoom`-parity resize of a 3D volume via per-axis
    1D operator matrices (see `_zoom1d_matrix`)."""
    out = np.asarray(vol, np.float32)
    for ax in range(3):
        if out.shape[ax] == out_shape[ax]:
            continue
        m = _zoom1d_matrix(out.shape[ax], out_shape[ax], order)
        # one contiguous 2D GEMM per axis (a strided batched matmul on the
        # moveaxis view hits numpy's slow fallback path — measured 940 ms
        # vs 90 ms for the 96³→128³ up-zoom)
        moved = np.ascontiguousarray(np.moveaxis(out, ax, 0))
        flat = moved.reshape(moved.shape[0], -1)
        res = m.T @ flat  # (n_out, rest)
        out = np.moveaxis(
            res.reshape((out_shape[ax],) + moved.shape[1:]), 0, ax
        )
    return np.ascontiguousarray(out)


class SimulateLowResolution:
    def __init__(self, p: float = 0.25, zoom_range: Tuple[float, float] = (0.5, 1.0),
                 p_per_channel: float = 0.5):
        self.p = p
        self.zoom_range = zoom_range
        self.p_per_channel = p_per_channel

    def __call__(self, sample, rng):
        from scipy import ndimage

        if rng.uniform() >= self.p:
            return sample
        sample = dict(sample)
        data = sample["data"].copy()
        for c in range(data.shape[0]):
            if rng.uniform() < self.p_per_channel:
                z = rng.uniform(*self.zoom_range)
                small = ndimage.zoom(data[c], z, order=0)
                data[c] = _separable_zoom(small, data[c].shape, order=3)
        sample["data"] = data
        return sample


class GammaTransform:
    def __init__(self, p: float = 0.3, gamma_range: Tuple[float, float] = (0.7, 1.5),
                 invert_image: bool = False, retain_stats: bool = True):
        self.p = p
        self.gamma_range = gamma_range
        self.invert_image = invert_image
        self.retain_stats = retain_stats

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        sample = dict(sample)
        data = sample["data"].copy()
        for c in range(data.shape[0]):
            img = -data[c] if self.invert_image else data[c]
            mean, std = img.mean(), img.std()
            mn, rngv = img.min(), img.max() - img.min() + 1e-8
            gamma = rng.uniform(*self.gamma_range)
            img = ((img - mn) / rngv) ** gamma * rngv + mn
            if self.retain_stats:
                img = (img - img.mean()) / max(img.std(), 1e-8) * std + mean
            data[c] = -img if self.invert_image else img
        sample["data"] = data
        return sample


class MirrorTransform:
    def __init__(self, axes: Tuple[int, ...] = (0, 1, 2), p_per_axis: float = 0.5):
        self.axes = axes
        self.p_per_axis = p_per_axis

    def __call__(self, sample, rng):
        sample = dict(sample)
        data, seg = sample["data"], sample.get("seg")
        for ax in self.axes:
            if rng.uniform() < self.p_per_axis:
                data = np.flip(data, axis=ax + 1)
                if seg is not None:
                    seg = np.flip(seg, axis=ax + 1)
        sample["data"] = np.ascontiguousarray(data)
        if seg is not None:
            sample["seg"] = np.ascontiguousarray(seg)
        return sample


class RemoveLabelTransform:
    """-1 (outside nonzero mask) → 0 (`train_augment.py` RemoveLabel)."""

    def __init__(self, remove: float = -1, replace_with: float = 0):
        self.remove = remove
        self.replace_with = replace_with

    def __call__(self, sample, rng):
        if sample.get("seg") is None:
            return sample
        sample = dict(sample)
        seg = sample["seg"].copy()
        seg[seg == self.remove] = self.replace_with
        sample["seg"] = seg
        return sample


def get_train_transforms(fast_spatial: bool = False) -> Compose:
    """Full nnUNet-style stack (`train_augment.py:23-62`).

    `fast_spatial=True` resamples with the native OpenMP trilinear kernel
    (order 1) instead of scipy's order-3 spline — ~an order of magnitude
    faster per worker with negligible augmentation-quality impact.
    """
    return Compose([
        SpatialTransform(order_data=1 if fast_spatial else 3),
        GaussianNoise(p=0.1),
        GaussianBlur(p=0.2, sigma=(0.5, 1.0), p_per_channel=0.5),
        BrightnessMultiplicative(p=0.15),
        ContrastAugmentation(p=0.15),
        SimulateLowResolution(p=0.25),
        GammaTransform(p=0.1, invert_image=True),
        GammaTransform(p=0.3, invert_image=False),
        MirrorTransform(axes=(0, 1, 2)),
        RemoveLabelTransform(),
    ])


def get_train_transforms_nomirror() -> Compose:
    t = get_train_transforms()
    t.transforms = [x for x in t.transforms if not isinstance(x, MirrorTransform)]
    return t


def get_train_transforms_onlymirror() -> Compose:
    return Compose([MirrorTransform(axes=(0, 1, 2)), RemoveLabelTransform()])


def get_train_transforms_onlyspatial() -> Compose:
    return Compose([SpatialTransform(), RemoveLabelTransform()])


def get_train_transforms_noaug() -> Compose:
    return Compose([RemoveLabelTransform()])


def get_validation_transforms() -> Compose:
    """(`train_augment.py:228-236`)."""
    return Compose([RemoveLabelTransform()])
