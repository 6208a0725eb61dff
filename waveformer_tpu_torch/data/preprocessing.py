"""nnUNet-style offline preprocessing (host numpy/scipy).

Capability match for `light_training/preprocessing/` (SURVEY.md §3.4):
crop-to-nonzero, per-channel normalization, spacing resampling with
separate-z handling, foreground-location sampling, dataset
fingerprint/planning, and a spawn-pool driver with worker-death detection
(`default_preprocessor.py:485-529`). Artifacts keep the reference's format —
`{case}.npz` (data+seg) + `{case}.pkl` (properties with the same key names,
`default_preprocessor.py:159-204`) — so existing split lists interoperate.

A copy of `waveformer_tpu/data/preprocessing.py` on the port's own
`utils/nifti.py` and `data/planning.py`: the same numpy/scipy calls in the
same order, so a case gives the same arrays and properties as the JAX
package. It imports no torch, so the spawn pool's workers start fast.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from waveformer_tpu_torch.data.planning import plan_experiment
from waveformer_tpu_torch.utils import nifti


# --------------------------------------------------------------------------- #
# cropping (`preprocessing/cropping/cropping.py:24-49`)
# --------------------------------------------------------------------------- #


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """(C, D, H, W) → binary mask where any channel is nonzero (hole-filled)."""
    from scipy import ndimage

    mask = (np.abs(data) > 0).any(axis=0)
    return ndimage.binary_fill_holes(mask)


def get_bbox_from_mask(mask: np.ndarray) -> List[List[int]]:
    bbox = []
    for ax in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != ax)
        any_ax = mask.any(axis=other)
        nz = np.nonzero(any_ax)[0]
        if len(nz) == 0:
            bbox.append([0, mask.shape[ax]])
        else:
            bbox.append([int(nz[0]), int(nz[-1]) + 1])
    return bbox


def crop_to_bbox(arr: np.ndarray, bbox: Sequence[Sequence[int]]) -> np.ndarray:
    sl = tuple(slice(b[0], b[1]) for b in bbox)
    return arr[(slice(None),) + sl] if arr.ndim == len(bbox) + 1 else arr[sl]


def crop_to_nonzero(
    data: np.ndarray, seg: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray], List[List[int]]]:
    """Crop (C, D, H, W) data (+seg) to the nonzero bbox; mark outside-mask
    background voxels in seg as -1 (nnUNet convention for masked norm and
    the RemoveLabel(-1→0) augmentation)."""
    mask = create_nonzero_mask(data)
    bbox = get_bbox_from_mask(mask)
    data = crop_to_bbox(data, bbox)
    mask_c = crop_to_bbox(mask, bbox)
    if seg is not None:
        seg = crop_to_bbox(seg, bbox)
        seg = seg.copy()
        seg[(seg == 0) & (~mask_c[None] if seg.ndim == 4 else ~mask_c)] = -1
    return data, seg, bbox


# --------------------------------------------------------------------------- #
# normalization (`preprocessing/normalization/default_normalization_schemes.py`)
# --------------------------------------------------------------------------- #


class ZScoreNormalization:
    """Per-channel z-score; optional brain-mask restriction (`:28-50`)."""

    def __init__(self, use_mask_for_norm: bool = False, intensityproperties=None):
        self.use_mask_for_norm = use_mask_for_norm

    def run(self, image: np.ndarray, seg: np.ndarray) -> np.ndarray:
        image = image.astype(np.float32, copy=True)
        if self.use_mask_for_norm:
            mask = seg >= 0
            mean, std = image[mask].mean(), image[mask].std()
            image[mask] = (image[mask] - mean) / max(std, 1e-8)
            image[~mask] = 0
        else:
            mean, std = image.mean(), image.std()
            image = (image - mean) / max(std, 1e-8)
        return image


class CTNormalization:
    """Percentile clip + z-score with dataset fingerprint stats (`:83-95`)."""

    def __init__(self, use_mask_for_norm: bool = False, intensityproperties=None):
        if not intensityproperties:
            raise ValueError("CTNormalization requires intensity properties")
        self.props = intensityproperties

    def run(self, image: np.ndarray, seg: np.ndarray) -> np.ndarray:
        p = self.props
        image = np.clip(
            image.astype(np.float32), p["percentile_00_5"], p["percentile_99_5"]
        )
        return (image - p["mean"]) / max(p["std"], 1e-8)


class Rescale01Normalization:
    """(`:98-110`)."""

    def __init__(self, *a, **k):
        pass

    def run(self, image, seg):
        image = image.astype(np.float32)
        lo, hi = image.min(), image.max()
        return (image - lo) / max(hi - lo, 1e-8)


class RGBTo01Normalization:
    """uint8 RGB scaled to [0, 1] (`:114-125`); rejects non-RGB ranges."""

    def __init__(self, *a, **k):
        pass

    def run(self, image, seg):
        if image.min() < 0 or image.max() > 255:
            raise ValueError(
                "RGB normalization expects uint8-range values in [0, 255]; "
                f"got [{image.min()}, {image.max()}]"
            )
        return image.astype(np.float32) / 255.0


class NoNormalization:
    def __init__(self, *a, **k):
        pass

    def run(self, image, seg):
        return image.astype(np.float32)


# --------------------------------------------------------------------------- #
# resampling (`preprocessing/resampling/default_resampling.py`)
# --------------------------------------------------------------------------- #

ANISO_THRESHOLD = 3.0  # nnUNet separate-z anisotropy trigger


def compute_new_shape(
    old_shape: Sequence[int],
    old_spacing: Sequence[float],
    new_spacing: Sequence[float],
) -> Tuple[int, ...]:
    """(`default_resampling.py:23-30`)."""
    return tuple(
        int(round(o * osp / nsp))
        for o, osp, nsp in zip(old_shape, old_spacing, new_spacing)
    )


def _resize_3d(vol: np.ndarray, new_shape, order: int) -> np.ndarray:
    from scipy import ndimage

    if tuple(vol.shape) == tuple(new_shape):
        return vol.astype(np.float32)
    zoom = [n / o for n, o in zip(new_shape, vol.shape)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = ndimage.zoom(
            vol.astype(np.float32), zoom, order=order, mode="nearest",
            grid_mode=True,
        )
    # guard rounding: force exact shape
    sl = tuple(slice(0, n) for n in new_shape)
    if out.shape != tuple(new_shape):
        pad = [(0, max(0, n - s)) for n, s in zip(new_shape, out.shape)]
        out = np.pad(out, pad, mode="edge")[sl]
    return out


def resample_data_or_seg_to_shape(
    data: np.ndarray,
    new_shape: Sequence[int],
    current_spacing: Sequence[float],
    new_spacing: Sequence[float],
    is_seg: bool = False,
    order: int = 3,
    order_z: int = 0,
) -> np.ndarray:
    """(C, D, H, W) → (C, *new_shape). Matches nnUNet behaviour
    (`default_resampling.py:78-217`): cubic for data / linear-via-one-hot for
    seg; strongly anisotropic volumes resample in-plane first with order-0
    along the out-of-plane axis."""
    new_shape = tuple(int(v) for v in new_shape)
    spacing_ratio = max(current_spacing) / min(current_spacing)
    do_separate_z = spacing_ratio > ANISO_THRESHOLD
    z_axis = int(np.argmax(current_spacing)) if do_separate_z else None

    def resample_channel(vol: np.ndarray, ordr: int) -> np.ndarray:
        if not do_separate_z:
            return _resize_3d(vol, new_shape, ordr)
        # in-plane 2D resize slice by slice, then order_z along z
        vol_m = np.moveaxis(vol, z_axis, 0)
        tgt = list(new_shape)
        tgt_z = tgt.pop(z_axis)
        inplane = np.stack(
            [_resize_3d(s[None], (1, *tgt), ordr)[0] for s in vol_m]
        )
        out = _resize_3d(inplane, (tgt_z, *tgt), order_z)
        return np.moveaxis(out, 0, z_axis)

    if not is_seg:
        return np.stack(
            [resample_channel(c, order) for c in data.astype(np.float32)]
        )
    # seg: one-hot linear interpolation then argmax (label-safe)
    out_channels = []
    for c in range(data.shape[0]):
        seg_c = data[c]
        labels = np.sort(np.unique(seg_c))
        if len(labels) == 1:
            out_channels.append(
                np.full(new_shape, labels[0], dtype=data.dtype)
            )
            continue
        votes = np.stack(
            [resample_channel((seg_c == l).astype(np.float32), 1) for l in labels]
        )
        out_channels.append(labels[np.argmax(votes, axis=0)].astype(data.dtype))
    return np.stack(out_channels)


# --------------------------------------------------------------------------- #
# foreground sampling (`default_preprocessor.py:455-483`)
# --------------------------------------------------------------------------- #


def sample_foreground_locations(
    seg: np.ndarray,
    classes: Sequence[int],
    max_per_class: int = 10000,
    min_per_class: int = 1000,
    seed: int = 1234,
) -> Dict[int, np.ndarray]:
    """≤10k (b, z, y, x) coordinates per class, nnUNet-style."""
    rng = np.random.RandomState(seed)
    out: Dict[int, np.ndarray] = {}
    if seg.ndim == 3:
        seg = seg[None]
    for c in classes:
        coords = np.argwhere(seg == c)  # (n, 4) with leading channel dim 0
        n = len(coords)
        if n == 0:
            out[int(c)] = coords
            continue
        target = min(n, max(min_per_class, int(math.ceil(n * 0.01))))
        target = min(target, max_per_class)
        idx = rng.choice(n, target, replace=False)
        out[int(c)] = coords[idx]
    return out


def sample_foreground_locations_regions(
    seg: np.ndarray,
    regions: Sequence,
    max_per_class: int = 10000,
    min_per_class: int = 1000,
    seed: int = 1234,
) -> Dict:
    """Region-format foreground sampling (the nnUNet regions mode the
    reference invokes via `_sample_foreground_locations(seg, all_labels,
    True)`, `preprocessor_multiinput_and_region.py:109-111`).

    Each region is a label OR a sequence of labels treated as one
    oversampling target (e.g. BraTS regions [[1, 2, 3], [2, 3], [3]]).
    Keys are the region tuples — `PatchSampler.get_bbox` consumes them
    like any other class key."""
    rng = np.random.RandomState(seed)
    out: Dict = {}
    if seg.ndim == 3:
        seg = seg[None]
    for region in regions:
        labels = (
            (int(region),)
            if np.isscalar(region)
            else tuple(int(v) for v in region)
        )
        coords = np.argwhere(np.isin(seg, labels))
        n = len(coords)
        key = labels[0] if len(labels) == 1 else labels
        if n == 0:
            out[key] = coords
            continue
        target = min(n, max(min_per_class, int(math.ceil(n * 0.01))))
        target = min(target, max_per_class)
        idx = rng.choice(n, target, replace=False)
        out[key] = coords[idx]
    return out


# --------------------------------------------------------------------------- #
# preprocessors
# --------------------------------------------------------------------------- #


def load_canonical_nifti(path: str):
    """Load a NIfTI and reorient it to RAS voxel order.

    Matches the reference's SimpleITK read path, which applies direction
    cosines so every case reaches the pipeline in one consistent anatomical
    frame (`preprocessor_mri.py:58-89`). Returns
    ``(canonical NiftiImage, source affine, orientation ornt)``; the ornt +
    source affine let the predictor write results back in the SOURCE voxel
    geometry (`Predictor.save_to_nii`)."""
    img = nifti.load(path)
    can, ornt = nifti.as_canonical(img)
    return can, img.affine, ornt


def _orientation_properties(properties: Dict, can, src_affine, ornt) -> Dict:
    """Record the source geometry in the nnUNet-style properties dict."""
    properties["source_affine"] = np.asarray(src_affine, float).tolist()
    properties["canonical_affine"] = np.asarray(can.affine, float).tolist()
    properties["orientation"] = np.asarray(ornt, float).tolist()
    return properties


@dataclass
class DefaultPreprocessor:
    """Offline case preprocessing + dataset planning
    (`default_preprocessor.py` capability)."""

    base_dir: str = "."
    out_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    normalization: str = "zscore"
    foreground_classes: Tuple[int, ...] = (1, 2, 3)

    _NORMALIZERS = {
        "zscore": ZScoreNormalization,
        "ct": CTNormalization,
        "rescale01": Rescale01Normalization,
        "rgb": RGBTo01Normalization,
        "none": NoNormalization,
    }

    # ---------------- per-case pipeline ---------------- #
    def run_case_npy(
        self,
        data: np.ndarray,
        seg: Optional[np.ndarray],
        properties: Dict,
        intensity_props: Optional[Dict] = None,
    ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict]:
        """(C, D, H, W) raw → cropped/normalized/resampled, with the
        reference's property keys (`default_preprocessor.py:155-228`)."""
        data = np.asarray(data, np.float32)
        original_spacing = list(properties["spacing"])
        properties["original_spacing_trans"] = original_spacing
        properties["target_spacing_trans"] = list(self.out_spacing)
        properties["shape_before_cropping"] = tuple(data.shape[1:])

        data, seg, bbox = crop_to_nonzero(data, seg)
        properties["bbox_used_for_cropping"] = bbox
        properties["shape_after_cropping_before_resample"] = tuple(data.shape[1:])

        data = self._normalize(data, seg, intensity_props)

        new_shape = compute_new_shape(
            data.shape[1:], original_spacing, self.out_spacing
        )
        data = resample_data_or_seg_to_shape(
            data, new_shape, original_spacing, self.out_spacing, is_seg=False
        )
        if seg is not None:
            seg = resample_data_or_seg_to_shape(
                seg, new_shape, original_spacing, self.out_spacing,
                is_seg=True, order=1,
            )
        properties["shape_after_resample"] = tuple(new_shape)

        if seg is not None:
            properties["class_locations"] = sample_foreground_locations(
                seg, self.foreground_classes
            )
        return data, seg, properties

    def _normalize(self, data, seg, intensity_props):
        cls = self._NORMALIZERS[self.normalization]
        seg_ref = seg[0] if seg is not None else np.zeros(data.shape[1:], np.int8)
        for c in range(data.shape[0]):
            props_c = (
                intensity_props.get(c) if intensity_props else None
            )
            data[c] = cls(
                use_mask_for_norm=False, intensityproperties=props_c
            ).run(data[c], seg_ref)
        return data

    # ---------------- IO ---------------- #
    def read_data(self, case_name: str):
        """Override per dataset. Returns (data (C,D,H,W), seg (1,D,H,W) or
        None, properties with at least 'spacing')."""
        raise NotImplementedError

    def get_iterable_list(self) -> List[str]:
        raise NotImplementedError

    def run_case_save(self, case_name: str, out_dir: str,
                      intensity_props: Optional[Dict] = None) -> str:
        data, seg, properties = self.read_data(case_name)
        data, seg, properties = self.run_case_npy(
            data, seg, properties, intensity_props
        )
        os.makedirs(out_dir, exist_ok=True)
        out_base = os.path.join(out_dir, case_name)
        if seg is not None:
            np.savez_compressed(out_base + ".npz", data=data, seg=seg)
        else:
            np.savez_compressed(out_base + ".npz", data=data)
        with open(out_base + ".pkl", "wb") as f:
            pickle.dump(properties, f)
        return case_name

    # ---------------- multiprocess driver ---------------- #
    def run(self, out_dir: str, num_processes: int = 8,
            intensity_props: Optional[Dict] = None) -> List[str]:
        """Spawn pool with worker-death detection
        (`default_preprocessor.py:485-529`)."""
        cases = self.get_iterable_list()
        if num_processes <= 1:
            return [self.run_case_save(c, out_dir, intensity_props) for c in cases]
        ctx = mp.get_context("spawn")
        with ctx.Pool(num_processes) as pool:
            results = [
                pool.apply_async(
                    self.run_case_save, (c, out_dir, intensity_props)
                )
                for c in cases
            ]
            done: List[str] = []
            for r in results:
                try:
                    done.append(r.get())
                except Exception as e:  # worker died or raised
                    raise RuntimeError(
                        "a preprocessing worker failed — if this was an "
                        "out-of-memory kill, reduce num_processes"
                    ) from e
        return done

    # ---------------- planning / fingerprint ---------------- #
    def run_plan(self, sample_cases: Optional[int] = 50) -> Dict:
        """Dataset fingerprint (`default_preprocessor.py:348-411` capability):
        median spacing/shape, per-channel foreground intensity stats, and an
        nnUNet-style patch-size suggestion."""
        cases = self.get_iterable_list()
        if sample_cases:
            cases = cases[:sample_cases]
        spacings, shapes = [], []
        inten: Dict[int, List[np.ndarray]] = {}
        for c in cases:
            data, seg, props = self.read_data(c)
            spacings.append(props["spacing"])
            shapes.append(data.shape[1:])
            if seg is not None:
                fg = seg[0] > 0
                for ch in range(data.shape[0]):
                    v = data[ch][fg]
                    if len(v):
                        inten.setdefault(ch, []).append(
                            np.random.default_rng(0).choice(
                                v, min(len(v), 10000), replace=False
                            )
                        )
        median_spacing = np.median(np.asarray(spacings), axis=0).tolist()
        median_shape = np.median(np.asarray(shapes), axis=0).astype(int).tolist()
        intensity_props = {}
        for ch, vals in inten.items():
            v = np.concatenate(vals)
            intensity_props[ch] = {
                "mean": float(v.mean()),
                "std": float(v.std()),
                "percentile_00_5": float(np.percentile(v, 0.5)),
                "percentile_99_5": float(np.percentile(v, 99.5)),
                "median": float(np.median(v)),
            }
        new_median_shape = compute_new_shape(
            median_shape, median_spacing, self.out_spacing
        )
        # real nnUNet derivation (default_preprocessor.py:389-400):
        # anisotropy-corrected target spacing → spacing-proportional
        # initial patch → axis-wise pool/conv schedule + padded patch
        plan = plan_experiment(spacings, shapes)
        return {
            "median_spacing": median_spacing,
            "median_shape": median_shape,
            "median_shape_resampled": list(new_median_shape),
            "intensities_per_channel": intensity_props,
            "suggested_patch_size": plan["patch_size"],
            "n_cases_fingerprinted": len(cases),
            **plan,
        }


@dataclass
class MultiModalityPreprocessor(DefaultPreprocessor):
    """Multi-modality MRI preprocessing (`preprocessor_mri.py:32-116`):
    stacks N modality NIfTIs + optional seg per case directory, per-channel
    z-score."""

    image_dir: str = ""
    data_filenames: Tuple[str, ...] = ("t2w.nii.gz", "t2f.nii.gz", "t1n.nii.gz", "t1c.nii.gz")
    seg_filename: Optional[str] = "seg.nii.gz"

    def get_iterable_list(self) -> List[str]:
        root = os.path.join(self.base_dir, self.image_dir)
        return sorted(os.listdir(root))

    def read_data(self, case_name: str):
        case_dir = os.path.join(self.base_dir, self.image_dir, case_name)
        vols = []
        spacing = None
        geo = None  # (canonical img, source affine, ornt) of first modality
        for fname in self.data_filenames:
            can, src_affine, ornt = load_canonical_nifti(
                os.path.join(case_dir, fname)
            )
            if geo is None:
                geo = (can, src_affine, ornt)
            # canonical axis order is (X, Y, Z); transpose to (Z,Y,X)=(D,H,W)
            vols.append(np.ascontiguousarray(can.data.T).astype(np.float32))
            spacing = can.spacing[::-1]
        data = np.stack(vols)
        seg = None
        if self.seg_filename:
            seg_path = os.path.join(case_dir, self.seg_filename)
            if os.path.exists(seg_path):
                seg_can, _, _ = load_canonical_nifti(seg_path)
                seg = np.ascontiguousarray(seg_can.data.T).astype(np.int8)[None]
        properties = {"spacing": list(spacing), "raw_size": list(data.shape[1:]),
                      "name": case_name}
        return data, seg, _orientation_properties(properties, *geo)


@dataclass
class GlobalContextPreprocessor(MultiModalityPreprocessor):
    """BraTS23-global variant (`preprocessor_brats23_global.py:171-307`):
    alongside the standard crop/normalize/resample artifacts, emits a
    whole-volume context pair — the resampled case downsampled to a fixed
    `global_size` (data order-3, seg order-1) — stored as `data_global` /
    `seg_global` keys in the SAME `{case}.npz`, so `GlobalContextDataset`
    reads the context channel without recomputation."""

    global_size: Tuple[int, int, int] = (128, 128, 128)

    def run_case_npy(self, data, seg, properties, intensity_props=None):
        data, seg, properties = super().run_case_npy(
            data, seg, properties, intensity_props
        )
        # global view: the full (cropped+resampled) volume at a fixed coarse
        # shape (`preprocessor_brats23_global.py:210-246`)
        spacing = list(self.out_spacing)
        data_global = resample_data_or_seg_to_shape(
            data, self.global_size, spacing, spacing,
            is_seg=False, order=3, order_z=0,
        ).astype(np.float32)
        properties["global_size"] = tuple(int(s) for s in self.global_size)
        properties["data_global"] = data_global
        if seg is not None:
            properties["seg_global"] = resample_data_or_seg_to_shape(
                seg, self.global_size, spacing, spacing,
                is_seg=True, order=1, order_z=0,
            ).astype(seg.dtype)
        return data, seg, properties

    def run_case_save(self, case_name: str, out_dir: str,
                      intensity_props: Optional[Dict] = None) -> str:
        data, seg, properties = self.read_data(case_name)
        data, seg, properties = self.run_case_npy(
            data, seg, properties, intensity_props
        )
        data_global = properties.pop("data_global")
        seg_global = properties.pop("seg_global", None)
        os.makedirs(out_dir, exist_ok=True)
        out_base = os.path.join(out_dir, case_name)
        arrays = {"data": data, "data_global": data_global}
        if seg is not None:
            arrays["seg"] = seg
        if seg_global is not None:
            arrays["seg_global"] = seg_global
        np.savez_compressed(out_base + ".npz", **arrays)
        with open(out_base + ".pkl", "wb") as f:
            pickle.dump(properties, f)
        return case_name


@dataclass
class CTPreprocessor(DefaultPreprocessor):
    """Flat-file CT dataset preprocessing (liver2017 capability,
    `default_preprocessor_liver_2017.py:231-259`): cases are
    `{volume_prefix}{case}{ext}` / `{seg_prefix}{case}{ext}` pairs in one
    directory, single channel, CT percentile-clip normalization from the
    dataset fingerprint."""

    volume_prefix: str = "volume-"
    seg_prefix: str = "segmentation-"
    ext: str = ".nii.gz"
    normalization: str = "ct"
    foreground_classes: Tuple[int, ...] = (1, 2)

    def get_iterable_list(self) -> List[str]:
        names = []
        for f in sorted(os.listdir(self.base_dir)):
            if f.startswith(self.volume_prefix) and f.endswith(self.ext):
                names.append(f[len(self.volume_prefix) : -len(self.ext)])
        return names

    def read_data(self, case_name: str):
        can, src_affine, ornt = load_canonical_nifti(
            os.path.join(self.base_dir, f"{self.volume_prefix}{case_name}{self.ext}")
        )
        data = np.ascontiguousarray(can.data.T).astype(np.float32)[None]
        seg = None
        seg_path = os.path.join(
            self.base_dir, f"{self.seg_prefix}{case_name}{self.ext}"
        )
        if os.path.exists(seg_path):
            seg_can, _, _ = load_canonical_nifti(seg_path)
            seg = np.ascontiguousarray(seg_can.data.T).astype(np.int8)[None]
        properties = {
            "spacing": list(can.spacing[::-1]),
            "raw_size": list(data.shape[1:]),
            "name": case_name,
        }
        return data, seg, _orientation_properties(
            properties, can, src_affine, ornt
        )


@dataclass
class OrganMaskPreprocessor(DefaultPreprocessor):
    """Per-organ binary-mask CT dataset preprocessing (AbdomenAtlas
    capability, `default_preprocessor_AbdomenAtlas1_0Mini.py:235-272`):
    each case directory holds one CT volume plus a segmentation directory
    of per-organ binary masks, combined into one multi-class label map
    (organ i → label i+1, later masks overwrite earlier ones, exactly the
    reference's `segs[seg_arr == 1] = index` semantics)."""

    image_name: str = "ct.nii.gz"
    seg_dir: str = "segmentations"
    seg_list: Tuple[str, ...] = ()
    normalization: str = "ct"
    foreground_classes: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.seg_list and not self.foreground_classes:
            self.foreground_classes = tuple(range(1, len(self.seg_list) + 1))

    def get_iterable_list(self) -> List[str]:
        return sorted(
            d
            for d in os.listdir(self.base_dir)
            if os.path.isdir(os.path.join(self.base_dir, d))
        )

    def read_data(self, case_name: str):
        case_dir = os.path.join(self.base_dir, case_name)
        can, src_affine, ornt = load_canonical_nifti(
            os.path.join(case_dir, self.image_name)
        )
        data = np.ascontiguousarray(can.data.T).astype(np.float32)[None]
        seg = None
        seg_root = os.path.join(case_dir, self.seg_dir)
        if os.path.isdir(seg_root) and self.seg_list:
            combined = None
            for index, target in enumerate(self.seg_list, start=1):
                m_can, _, _ = load_canonical_nifti(
                    os.path.join(seg_root, target)
                )
                m = np.ascontiguousarray(m_can.data.T)
                if combined is None:
                    combined = np.zeros(m.shape, np.int8)
                combined[m == 1] = index
            seg = combined[None]
        properties = {
            "spacing": list(can.spacing[::-1]),
            "raw_size": list(data.shape[1:]),
            "name": case_name,
        }
        return data, seg, _orientation_properties(
            properties, can, src_affine, ornt
        )


@dataclass
class MultiInputRegionPreprocessor(MultiModalityPreprocessor):
    """N separate input images per case + region-format label sampling
    (`preprocessor_multiinput_and_region.py:32-208` capability).

    Differences from the plain multi-modality MRI preprocessor, matching
    the reference variant: per-channel CT normalization driven by supplied
    `foreground_intensity_properties_per_channel` (`:51-58`), and
    `class_locations` sampled per REGION — groups of labels oversampled as
    one target (`:109-111`, nnUNet regions mode) — for region-based
    training with `training.losses.dice_bce_loss` (sigmoid DC+BCE over
    region channels).

    `regions`: e.g. ((1, 2, 3), (2, 3), (3,)) for BraTS WT/TC/ET, or
    scalars for plain labels.
    """

    normalization: str = "ct"
    regions: Tuple = ()

    def run_case_npy(self, data, seg, properties, intensity_props=None):
        data, seg, properties = super().run_case_npy(
            data, seg, properties, intensity_props
        )
        if seg is not None and self.regions:
            properties["class_locations"] = sample_foreground_locations_regions(
                seg, self.regions
            )
        return data, seg, properties
