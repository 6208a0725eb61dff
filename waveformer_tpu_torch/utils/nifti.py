"""Minimal NIfTI-1 reader/writer (pure numpy, gzip-aware).

A copy of `waveformer_tpu/utils/nifti.py`, so the port reads and writes
NIfTI without nibabel or the JAX package; only its gzip level differs
(`GZIP_LEVEL`): the files hold the same header and data.

Replaces the reference's SimpleITK IO (`light_training/prediction.py:209-227`,
`preprocessor_mri.py:58-89`) — SimpleITK is not in this image, and the only
capabilities the pipeline needs are: read voxel data + spacing/affine, write
a segmentation with spacing. Implements the NIfTI-1 single-file (.nii/.nii.gz)
layout: 348-byte header, vox_offset 352, Fortran-ordered data.
"""

from __future__ import annotations

import gzip
import math
import struct
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    data: np.ndarray  # (X, Y, Z[, T]) — NIfTI axis order
    affine: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )

    @property
    def spacing(self) -> Tuple[float, float, float]:
        return tuple(float(np.linalg.norm(self.affine[:3, i])) for i in range(3))


# gzip level of written `.nii.gz` files. The JAX package writes at gzip's
# default, 9, which takes seconds on a BraTS-sized label map; level 1 (also
# nibabel's default) writes the same data at a few percent of that cost.
GZIP_LEVEL = 1


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode, compresslevel=GZIP_LEVEL)
    return open(path, mode)


def load(path: str) -> NiftiImage:
    with _open(path, "rb") as f:
        hdr = f.read(352)
        sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
        dim = struct.unpack_from("<8h", hdr, 40)
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1 : 1 + ndim])
        datatype = struct.unpack_from("<h", hdr, 70)[0]
        pixdim = struct.unpack_from("<8f", hdr, 76)
        vox_offset = int(struct.unpack_from("<f", hdr, 108)[0])
        scl_slope = struct.unpack_from("<f", hdr, 112)[0]
        scl_inter = struct.unpack_from("<f", hdr, 116)[0]
        qform_code = struct.unpack_from("<h", hdr, 252)[0]
        sform_code = struct.unpack_from("<h", hdr, 254)[0]
        quatern = struct.unpack_from("<3f", hdr, 256)  # b, c, d
        qoffset = struct.unpack_from("<3f", hdr, 268)  # x, y, z
        srow = np.asarray(
            struct.unpack_from("<12f", hdr, 280), np.float32
        ).reshape(3, 4)
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        np_dtype = _DTYPES[datatype]
        if vox_offset > 352:
            f.read(vox_offset - 352)
        raw = f.read(int(np.prod(shape)) * np.dtype(np_dtype).itemsize)
    data = np.frombuffer(raw, dtype=np_dtype).reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    affine = np.eye(4, dtype=np.float32)
    if sform_code > 0:
        affine[:3, :] = srow
    elif qform_code > 0:
        affine = _qform_to_affine(quatern, qoffset, pixdim).astype(np.float32)
    else:
        # fall back to pixdim spacing on the diagonal
        for i in range(3):
            affine[i, i] = pixdim[1 + i] if pixdim[1 + i] != 0 else 1.0
    return NiftiImage(data=data, affine=affine)


def _qform_to_affine(quatern, qoffset, pixdim) -> np.ndarray:
    """NIfTI-1 qform (quaternion + qfac) → 4×4 affine.

    Standard NIfTI-1 semantics (nifti1.h `quatern_to_mat44`): the rotation
    comes from the unit quaternion (a, b, c, d) with a reconstructed from
    b/c/d, columns scaled by pixdim[1:4], and the third column additionally
    multiplied by qfac = pixdim[0] (0 → +1)."""
    b, c, d = (float(q) for q in quatern)
    a2 = 1.0 - (b * b + c * c + d * d)
    a = math.sqrt(a2) if a2 > 0 else 0.0
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ],
        dtype=np.float64,
    )
    qfac = float(pixdim[0]) if pixdim[0] != 0 else 1.0
    scale = [
        pixdim[1] if pixdim[1] != 0 else 1.0,
        pixdim[2] if pixdim[2] != 0 else 1.0,
        (pixdim[3] if pixdim[3] != 0 else 1.0) * qfac,
    ]
    affine = np.eye(4)
    affine[:3, :3] = R * np.asarray(scale)[None, :]
    affine[:3, 3] = qoffset
    return affine


# --------------------------------------------------------------------------- #
# orientation (RAS canonicalization)
#
# The reference reads volumes through SimpleITK, which applies direction
# cosines (`light_training/preprocessing/preprocessors/preprocessor_mri.py:58-89`)
# so every case reaches the pipeline in a consistent anatomical axis order.
# These helpers provide the same guarantee: `io_orientation` extracts the
# closest axis-aligned orientation from the affine, `as_canonical` reorients
# the voxel array to RAS voxel order (updating the affine), and
# `inverse_orientation`/`apply_orientation` map predictions back to the
# source voxel order so `save_to_nii` can write in the SOURCE geometry
# (`light_training/prediction.py:209-227`).
# --------------------------------------------------------------------------- #


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """Per-voxel-axis (world_axis, direction) closest to the affine.

    Returns a (3, 2) array `ornt` where `ornt[j] = (w, s)` means voxel axis
    j of the array most strongly aligns with world axis w (0=R/L, 1=A/P,
    2=S/I), pointing in the +w direction when s=+1. Greedy max-|cosine|
    assignment, each world axis used once."""
    R = np.asarray(affine, np.float64)[:3, :3].copy()
    norms = np.linalg.norm(R, axis=0)
    norms[norms == 0] = 1.0
    Q = R / norms
    ornt = np.zeros((3, 2))
    scratch = np.abs(Q).copy()
    for _ in range(3):
        w, j = np.unravel_index(np.argmax(scratch), scratch.shape)
        ornt[j] = (w, 1.0 if Q[w, j] >= 0 else -1.0)
        scratch[w, :] = -1.0
        scratch[:, j] = -1.0
    return ornt


def apply_orientation(arr: np.ndarray, ornt: np.ndarray) -> np.ndarray:
    """Reorder a 3-D array's axes per `ornt`: flip axes with direction −1,
    then transpose so array axis k holds what pointed along world axis k."""
    ornt = np.asarray(ornt)
    out = np.asarray(arr)
    for j in range(3):
        if ornt[j, 1] < 0:
            out = np.flip(out, axis=j)
    perm = [0, 0, 0]
    for j in range(3):
        perm[int(ornt[j, 0])] = j
    return out.transpose(perm)


def inverse_orientation(ornt: np.ndarray) -> np.ndarray:
    """The orientation that undoes `apply_orientation(· , ornt)`."""
    ornt = np.asarray(ornt)
    inv = np.zeros_like(ornt)
    for j in range(3):
        w = int(ornt[j, 0])
        inv[w] = (j, ornt[j, 1])
    return inv


def orientation_affine(ornt: np.ndarray, reoriented_shape) -> np.ndarray:
    """4×4 voxel-coordinate map: reoriented indices → original indices.

    For original voxel coords x and reoriented coords x′:
    ``x[j] = s · x′[w] + c_j`` with (w, s) = ornt[j] and c_j = n_j − 1 on
    flipped axes (n_j = original extent = reoriented extent along w). The
    reoriented image's affine is therefore ``affine @ orientation_affine``."""
    ornt = np.asarray(ornt)
    T = np.eye(4)
    M = np.zeros((3, 3))
    c = np.zeros(3)
    for j in range(3):
        w = int(ornt[j, 0])
        s = ornt[j, 1]
        M[j, w] = s
        if s < 0:
            c[j] = int(reoriented_shape[w]) - 1
    T[:3, :3] = M
    T[:3, 3] = c
    return T


def as_canonical(img: NiftiImage) -> Tuple[NiftiImage, np.ndarray]:
    """Reorient to RAS voxel order; returns (reoriented image, ornt used).

    The returned image's affine maps ITS voxel indices to the same world
    coordinates as the source — world geometry is preserved exactly; only
    the in-memory axis order/direction changes."""
    ornt = io_orientation(img.affine)
    data = apply_orientation(img.data, ornt)
    affine = np.asarray(img.affine, np.float64) @ orientation_affine(
        ornt, data.shape
    )
    return NiftiImage(data=data, affine=affine.astype(np.float32)), ornt


def undo_canonical(arr: np.ndarray, ornt: np.ndarray) -> np.ndarray:
    """Map a canonical-order (RAS) voxel array back to source voxel order."""
    return apply_orientation(arr, inverse_orientation(np.asarray(ornt)))


def save(img: NiftiImage, path: str) -> None:
    data = np.asarray(img.data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[data.dtype]
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    spacing = NiftiImage(data=data, affine=img.affine).spacing
    pixdim = [1.0] + list(spacing) + [1.0] * (7 - 3)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<12f", hdr, 280, *np.asarray(img.affine[:3, :], np.float32).reshape(-1))
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)  # extension flag
        f.write(np.asfortranarray(data).tobytes(order="F"))
