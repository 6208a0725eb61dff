"""nnUNet experiment planning: patch-size / pool / conv-kernel derivation.

Faithful behavioural port of the reference's planning slice
(`light_training/preprocessing/preprocessors/default_preprocessor.py`):

* `get_shape_must_be_divisible_by`          (`default_preprocessor.py:37-38`)
* `pad_shape`                               (`default_preprocessor.py:40-58`)
* `get_pool_and_conv_props`                 (`default_preprocessor.py:60-135`)
* `determine_fullres_target_spacing`        (`default_preprocessor.py:305-334`)
* `initial_patch_size` + plan assembly      (`default_preprocessor.py:389-400`)

These are host-side numpy computations (they run once per dataset during
offline planning), so there is no device consideration here — the point is
exact agreement with nnUNet's derivation, especially on anisotropic
datasets where the axis-wise pooling schedule diverges from any
power-of-two heuristic.

All functions take spacings/shapes in a consistent axis order; this
framework uses (D, H, W) throughout (the reference mixes sitk (x, y, z)
spacing with (z, y, x) shapes and compensates with `[::-1]` reversals at
print/plan boundaries — we keep one order instead; the derived numbers
are identical because the algorithm is axis-order-equivariant).

A copy of `waveformer_tpu/data/planning.py`, whole (numpy only).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def get_shape_must_be_divisible_by(
    num_pool_per_axis: Sequence[int],
) -> np.ndarray:
    """2**pools per axis (`default_preprocessor.py:37-38`)."""
    return 2 ** np.asarray(num_pool_per_axis)


def pad_shape(shape: Sequence[int], must_be_divisible_by) -> np.ndarray:
    """Round each axis UP to the next multiple of `must_be_divisible_by`,
    except axes already divisible, which stay put
    (`default_preprocessor.py:40-58`)."""
    if not isinstance(must_be_divisible_by, (tuple, list, np.ndarray)):
        must_be_divisible_by = [must_be_divisible_by] * len(shape)
    assert len(must_be_divisible_by) == len(shape)
    new_shp = [
        shape[i] + must_be_divisible_by[i] - shape[i] % must_be_divisible_by[i]
        for i in range(len(shape))
    ]
    for i in range(len(shape)):
        if shape[i] % must_be_divisible_by[i] == 0:
            new_shp[i] -= must_be_divisible_by[i]
    return np.asarray(new_shp, dtype=int)


def get_pool_and_conv_props(
    spacing: Sequence[float],
    patch_size: Sequence[int],
    min_feature_map_size: int,
    max_numpool: int,
) -> Tuple[List[int], List[List[int]], List[List[int]], np.ndarray, np.ndarray]:
    """nnUNet's axis-wise pooling/kernel schedule
    (`default_preprocessor.py:60-135`, nnUNet v1
    `get_pool_and_conv_props_v2`).

    Greedy loop: each round pools (stride 2) every axis that (a) still has
    ≥ 2·min_feature_map_size voxels, (b) has current spacing within 2× of
    the finest current spacing, and (c) has not hit max_numpool. Conv
    kernels start at 1 per axis and switch to 3 permanently once the axis
    spacing comes within 2× of the finest spacing. A single remaining
    poolable axis keeps pooling only while it has ≥ 3·min_feature_map_size
    voxels. Returns (num_pool_per_axis, pool_op_kernel_sizes,
    conv_kernel_sizes, padded_patch_size, must_be_divisible_by).
    """
    dim = len(spacing)
    current_spacing = [float(s) for s in spacing]
    current_size = [float(p) for p in patch_size]

    pool_op_kernel_sizes: List[List[int]] = [[1] * dim]
    conv_kernel_sizes: List[List[int]] = []
    num_pool_per_axis = [0] * dim
    kernel_size = [1] * dim

    while True:
        valid_axes = [
            i for i in range(dim)
            if current_size[i] >= 2 * min_feature_map_size
        ]
        if len(valid_axes) < 1:
            break

        # NOTE: the reference captures this list BEFORE the spacing /
        # max_numpool filters and later indexes it by raw axis id inside
        # the kernel-size loop (`default_preprocessor.py:108-113`) — a
        # quirk we replicate exactly (guarded there, as here, by the
        # `kernel_size[d] == 3` early-continue).
        spacings_of_axes = [current_spacing[i] for i in valid_axes]

        min_spacing_of_valid = min(spacings_of_axes)
        valid_axes = [
            i for i in valid_axes
            if current_spacing[i] / min_spacing_of_valid < 2
        ]
        valid_axes = [
            i for i in valid_axes if num_pool_per_axis[i] < max_numpool
        ]

        if len(valid_axes) == 1:
            if current_size[valid_axes[0]] >= 3 * min_feature_map_size:
                pass
            else:
                break
        if len(valid_axes) < 1:
            break

        for d in range(dim):
            if kernel_size[d] == 3:
                continue
            if spacings_of_axes[d] / min(current_spacing) < 2:
                kernel_size[d] = 3

        pool_kernel_sizes = [1] * dim
        for v in valid_axes:
            pool_kernel_sizes[v] = 2
            num_pool_per_axis[v] += 1
            current_spacing[v] *= 2
            current_size[v] = float(np.ceil(current_size[v] / 2))

        pool_op_kernel_sizes.append(pool_kernel_sizes)
        conv_kernel_sizes.append(list(kernel_size))

    must_be_divisible_by = get_shape_must_be_divisible_by(num_pool_per_axis)
    padded_patch_size = pad_shape(patch_size, must_be_divisible_by)
    # one extra conv for the bottleneck, always 3^dim
    conv_kernel_sizes.append([3] * dim)
    return (
        num_pool_per_axis,
        pool_op_kernel_sizes,
        conv_kernel_sizes,
        padded_patch_size,
        must_be_divisible_by,
    )


def determine_fullres_target_spacing(
    spacings: Sequence[Sequence[float]],
    sizes: Sequence[Sequence[int]],
) -> np.ndarray:
    """Median spacing, with nnUNet's anisotropy correction
    (`default_preprocessor.py:305-334`): when the coarsest axis is > 3×
    coarser than the others AND has 3× fewer voxels, its target spacing is
    lowered to the dataset's 10th-percentile spacing on that axis
    (floored just above the finest other axis)."""
    spacings_arr = np.vstack([np.asarray(s, float) for s in spacings])
    sizes_arr = np.vstack([np.asarray(s, float) for s in sizes])
    target = np.percentile(spacings_arr, 50, 0)
    target_size = np.percentile(sizes_arr, 50, 0)

    worst_spacing_axis = int(np.argmax(target))
    other_axes = [i for i in range(len(target)) if i != worst_spacing_axis]
    other_spacings = [target[i] for i in other_axes]
    other_sizes = [target_size[i] for i in other_axes]

    has_aniso_spacing = target[worst_spacing_axis] > (3 * max(other_spacings))
    has_aniso_voxels = target_size[worst_spacing_axis] * 3 < min(other_sizes)
    if has_aniso_spacing and has_aniso_voxels:
        spacings_of_that_axis = spacings_arr[:, worst_spacing_axis]
        target_spacing_of_that_axis = np.percentile(spacings_of_that_axis, 10)
        if target_spacing_of_that_axis < max(other_spacings):
            target_spacing_of_that_axis = (
                max(max(other_spacings), target_spacing_of_that_axis) + 1e-5
            )
        target[worst_spacing_axis] = target_spacing_of_that_axis
    return target


def initial_patch_size(target_spacing: Sequence[float]) -> List[int]:
    """Spacing-proportional patch seed with 256³-voxel budget
    (`default_preprocessor.py:390-391`): axes with finer spacing get more
    voxels, total ≈ 256³ before the divisibility padding."""
    tmp = 1.0 / np.asarray(target_spacing, float)
    return [round(i) for i in tmp * (256**3 / np.prod(tmp)) ** (1 / 3)]


def plan_experiment(
    spacings: Sequence[Sequence[float]],
    sizes: Sequence[Sequence[int]],
    min_feature_map_size: int = 4,
    max_numpool: int = 999999,
) -> Dict:
    """Full nnUNet plan from per-case (spacing, raw shape) fingerprints
    (`default_preprocessor.py:381-411` flow): target spacing → median
    resampled shape → initial patch size → pool/conv schedule + padded
    patch size."""
    fullres_spacing = determine_fullres_target_spacing(spacings, sizes)
    new_shapes = [
        np.asarray(
            [
                int(round(osp / nsp * osh))
                for osp, nsp, osh in zip(sp, fullres_spacing, sh)
            ]
        )
        for sp, sh in zip(spacings, sizes)
    ]
    new_median_shape = np.median(np.vstack(new_shapes), 0)
    seed_patch = initial_patch_size(fullres_spacing)
    (
        num_pool_per_axis,
        pool_op_kernel_sizes,
        conv_kernel_sizes,
        patch_size,
        must_be_divisible_by,
    ) = get_pool_and_conv_props(
        fullres_spacing, seed_patch, min_feature_map_size, max_numpool
    )
    return {
        "target_spacing": [float(s) for s in fullres_spacing],
        "median_shape_resampled": [float(s) for s in new_median_shape],
        "initial_patch_size": list(seed_patch),
        "patch_size": [int(p) for p in patch_size],
        "num_pool_per_axis": list(num_pool_per_axis),
        "pool_op_kernel_sizes": pool_op_kernel_sizes,
        "conv_kernel_sizes": conv_kernel_sizes,
        "shape_must_be_divisible_by": [int(v) for v in must_be_divisible_by],
    }


# --------------------------------------------------------------------------- #
# plans as a first-class artifact
# --------------------------------------------------------------------------- #


PLANS_FILENAME = "plans.json"


@dataclass(frozen=True)
class Plans:
    """A persisted dataset plan that round-trips into pipeline configuration.

    The counterpart of the reference's plans handler
    (`light_training/utilities/plans_handling/plans_handler.py`): the
    preprocessing fingerprint (`DefaultPreprocessor.run_plan`) is saved once
    as `plans.json` next to the preprocessed data, and training/inference
    read their patch size, target spacing, and normalization from it instead
    of hand-copied config values. Unknown keys survive load→save untouched.
    """

    raw: Dict[str, Any] = field(default_factory=dict)

    # ---------------- persistence ---------------- #
    @classmethod
    def from_plan(
        cls,
        plan: Dict[str, Any],
        normalization: Optional[str] = None,
        foreground_classes: Optional[Sequence[int]] = None,
    ) -> "Plans":
        raw = dict(plan)
        if normalization is not None:
            raw["normalization"] = normalization
        if foreground_classes is not None:
            raw["foreground_classes"] = [int(c) for c in foreground_classes]
        return cls(raw=raw)

    @classmethod
    def load(cls, path: str) -> "Plans":
        with open(path) as f:
            return cls(raw=json.load(f))

    @classmethod
    def find(cls, data_dir: str) -> Optional["Plans"]:
        """Load `<data_dir>/plans.json` if present (legacy name `plan.json`
        accepted), else None."""
        for name in (PLANS_FILENAME, "plan.json"):
            p = os.path.join(data_dir, name)
            if os.path.exists(p):
                return cls.load(p)
        return None

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.raw, f, indent=2)

    # ---------------- typed accessors ---------------- #
    @property
    def patch_size(self) -> Tuple[int, ...]:
        return tuple(int(v) for v in self.raw["patch_size"])

    @property
    def target_spacing(self) -> Tuple[float, ...]:
        return tuple(float(v) for v in self.raw["target_spacing"])

    @property
    def normalization(self) -> Optional[str]:
        return self.raw.get("normalization")

    @property
    def foreground_classes(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in self.raw.get("foreground_classes", ()))

    @property
    def intensity_properties(self) -> Dict[int, Dict[str, float]]:
        """Per-channel foreground intensity stats, channel keys as ints
        (JSON stringifies them)."""
        raw = self.raw.get("intensities_per_channel", {})
        return {int(k): v for k, v in raw.items()}

    @property
    def pool_op_kernel_sizes(self) -> List[List[int]]:
        return [list(k) for k in self.raw.get("pool_op_kernel_sizes", [])]

    @property
    def conv_kernel_sizes(self) -> List[List[int]]:
        return [list(k) for k in self.raw.get("conv_kernel_sizes", [])]

    # ---------------- consumers ---------------- #
    def network_patch_size(self, divisor: int = 16) -> Tuple[int, ...]:
        """The plan's patch size rounded UP to the model's divisibility
        constraint (WaveFormer at patch_size 2 / decom levels (3,2,1,0)
        needs every axis divisible by 16: grid_i = axis/(2·2^i) must divide
        2^level_i at each stage)."""
        return tuple(
            int(-(-p // divisor) * divisor) for p in self.patch_size
        )

    def preprocessor_kwargs(self) -> Dict[str, Any]:
        """Kwargs for `DefaultPreprocessor` subclasses so raw cases at
        predict time get the exact training-time preprocessing."""
        out: Dict[str, Any] = {"out_spacing": self.target_spacing}
        if self.normalization is not None:
            out["normalization"] = self.normalization
        if self.foreground_classes:
            out["foreground_classes"] = self.foreground_classes
        return out

    def apply_to_config(self, cfg):
        """Feed the plan into a `waveformer_tpu_torch.config.Config`: training
        patch size (`roi_size`), the network's `img_size`, and the
        prediction ROI all take the plan's (model-divisible) patch size —
        the round-trip the reference performs through
        `plans_handler.get_network_from_plans`. Returns a new Config."""
        import dataclasses as _dc

        patch = self.network_patch_size()
        network = _dc.replace(cfg.network, img_size=patch)
        prediction = _dc.replace(cfg.prediction, patch_size=patch)
        return _dc.replace(
            cfg, roi_size=patch, network=network, prediction=prediction
        )
