"""Full-volume predictor: sliding window + TTA + geometry restoration.

Port of `waveformer_tpu/inference/predictor.py` (reference `Predictor`,
`light_training/prediction.py:29-227`), in the inferer's layout
((D, H, W, C) volumes by default, (C, D, H, W) with a channels-first
inferer):
  * mirror-TTA sliding-window logits on the device (`SlidingWindowInferer`);
  * trilinear resample of the logits to the pre-resampling crop shape;
  * argmax on the device, so only the uint8 label map comes back;
  * zero-embedding into the original volume via the preprocessing bbox,
    and the optional largest-connected-component post-process;
  * NIfTI export in the source geometry (`save_to_nii`).

Geometry rides in the nnUNet-style `properties` dict
(`shape_before_cropping`, `bbox_used_for_cropping`,
`shape_after_cropping_and_before_resampling`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.inference.sliding_window import SlidingWindowInferer
from waveformer_tpu_torch.ops.resize import resize_trilinear
from waveformer_tpu_torch.utils import nifti


def largest_connected_component(seg: np.ndarray) -> np.ndarray:
    """Keep only the largest foreground connected component (scipy)."""
    from scipy import ndimage

    labeled, n = ndimage.label(seg > 0)
    if n == 0:
        return seg
    sizes = ndimage.sum(np.ones_like(labeled), labeled, range(1, n + 1))
    keep = 1 + int(np.argmax(sizes))
    return np.where(labeled == keep, seg, 0).astype(seg.dtype)


def _crop_shape_key(properties: Dict) -> str:
    return (
        "shape_after_cropping_before_resample"
        if "shape_after_cropping_before_resample" in properties
        else "shape_after_cropping_and_before_resampling"
    )


class Predictor:
    """End-to-end full-volume inference on one device (the CUDA
    device unless `device` says otherwise)."""

    def __init__(
        self,
        inferer: SlidingWindowInferer,
        postprocess_largest_cc: bool = False,
        upload_dtype: Optional[torch.dtype] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """`upload_dtype`: host-side cast before the H2D copy. Pass the
        model's compute dtype (e.g. ``torch.bfloat16``) to halve the upload
        bytes; ``None`` uploads volumes at their stored dtype."""
        self.inferer = inferer
        self.postprocess_largest_cc = postprocess_largest_cc
        self.upload_dtype = upload_dtype
        self.device = resolve_device(device)

    @property
    def channels_first(self) -> bool:
        return getattr(self.inferer, "layout", "channels_last") == "channels_first"

    def predict_logits(
        self, volume: torch.Tensor, predictor_fn: Callable, out_channels: int
    ) -> torch.Tensor:
        """(D, H, W, C) preprocessed volume → blended TTA logits
        (D, H, W, out_channels), fp32, on the device; (C, D, H, W) →
        (out_channels, D, H, W) with a channels-first inferer."""
        return self.inferer(volume, predictor_fn, out_channels)

    def _resample(self, logits: torch.Tensor, properties: Dict) -> torch.Tensor:
        """Trilinear resize (align_corners=False) of the logits' spatial
        axes to `shape_after_cropping_and_before_resampling`."""
        target = tuple(int(v) for v in properties[_crop_shape_key(properties)])
        cf = self.channels_first
        if tuple(logits.shape[1:] if cf else logits.shape[:3]) != target:
            axes = (2, 3, 4) if cf else (1, 2, 3)
            logits = resize_trilinear(logits[None], target, axes=axes)[0]
        return logits

    def resample_logits_to_crop(self, logits: torch.Tensor, properties: Dict) -> np.ndarray:
        """The logits resized to the pre-resampling crop, on the host."""
        return self._resample(logits, properties).cpu().numpy()

    def embed_to_original(
        self, seg_crop: np.ndarray, properties: Dict, fill: int = 0
    ) -> np.ndarray:
        """Place the cropped segmentation back into the original volume."""
        original = tuple(int(v) for v in properties["shape_before_cropping"])
        bbox = properties["bbox_used_for_cropping"]
        out = np.full(original, fill, dtype=seg_crop.dtype)
        out[tuple(slice(int(b[0]), int(b[1])) for b in bbox)] = seg_crop
        return out

    def upload(self, volume, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Start the H2D copy: cast on the host first (to `dtype` if
        given), pin, then copy without blocking the host."""
        host = torch.as_tensor(np.asarray(volume))
        if dtype is not None and host.dtype != dtype:
            host = host.to(dtype)
        if self.device.type == "cpu":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def predict_case(
        self,
        volume,
        predictor_fn: Callable,
        out_channels: int,
        properties: Optional[Dict] = None,
    ) -> np.ndarray:
        """Volume → uint8 label map at the original geometry."""
        return self._finish_case(
            *self._start_case(volume, predictor_fn, out_channels, properties)
        )

    def _start_case(self, volume, predictor_fn, out_channels, properties):
        """Enqueue the device work of one case with no host sync: upload,
        TTA logits, resample to the crop, argmax. Returns the uint8 label
        tensor (not yet materialised) and the properties."""
        if not (isinstance(volume, torch.Tensor) and volume.device == self.device):
            volume = self.upload(volume, self.upload_dtype)
        with torch.inference_mode():
            logits = self.predict_logits(volume, predictor_fn, out_channels)
            if properties is not None:
                logits = self._resample(logits, properties)
            seg_dev = torch.argmax(logits, dim=0 if self.channels_first else -1)
            seg_dev = seg_dev.to(torch.uint8)
        return seg_dev, properties

    def _finish_case(self, seg_dev: torch.Tensor, properties) -> np.ndarray:
        """Wait for the device result and apply the host-side geometry."""
        seg = seg_dev.cpu().numpy()
        if properties is not None:
            seg = self.embed_to_original(seg, properties)
        if self.postprocess_largest_cc:
            seg = largest_connected_component(seg)
        return seg

    def predict_cases(
        self, volumes, predictor_fn: Callable, out_channels: int, properties_list=None
    ):
        """Pipelined multi-case prediction, yielding label maps in order:
        case i+1's upload and kernel launches are queued before case i's
        result is read back."""
        pending = None
        props_it = iter(properties_list) if properties_list is not None else None
        for vol in volumes:
            props = next(props_it) if props_it is not None else None
            started = self._start_case(vol, predictor_fn, out_channels, props)
            if pending is not None:
                yield self._finish_case(*pending)
            pending = started
        if pending is not None:
            yield self._finish_case(*pending)

    def save_to_nii(
        self,
        seg: np.ndarray,
        path: str,
        spacing: Sequence[float] = (1.0, 1.0, 1.0),
        affine: Optional[np.ndarray] = None,
        properties: Optional[Dict] = None,
    ) -> None:
        """NIfTI export in the SOURCE geometry (`prediction.py:209-227`).

        `seg` is in the pipeline's (D, H, W) = (Z, Y, X) canonical frame;
        NIfTI stores (X, Y, Z), so the array is transposed. When
        `properties` carries the preprocessing-time orientation record
        (`orientation` + `source_affine`), the segmentation is mapped back
        to the source file's voxel order and written with the source affine
        (voxel-exact overlay on the raw input). Otherwise a diagonal affine
        is made from `spacing`."""
        arr = seg.astype(np.uint8).T  # (D,H,W) → canonical (X,Y,Z)
        if properties is not None and "orientation" in properties:
            arr = nifti.undo_canonical(arr, np.asarray(properties["orientation"]))
            affine = np.asarray(properties["source_affine"], np.float32)
        elif affine is None:
            affine = np.diag(list(spacing)[::-1] + [1.0]).astype(np.float32)
        nifti.save(nifti.NiftiImage(data=arr, affine=affine), path)
