"""Native host runtime (C++/OpenMP) with ctypes bindings.

A copy of `waveformer_tpu/runtime/__init__.py` and its `wfdata.cpp`: the
augmentation's affine resampler, Gaussian blur and crop-pad on the host's
cores. These are host code, not device kernels. `libwfdata.so` is built
with g++ at first use into `waveformer_tpu_torch/_build/`; every entry
point has a pure-numpy/scipy fallback, so the package works without a
compiler. Check `available()` / set `WFTPU_DISABLE_NATIVE=1` to opt out.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "wfdata.cpp")
_LIB_PATH = os.path.join(os.path.dirname(_HERE), "_build", "libwfdata.so")

_lib = None
_lock = threading.Lock()


def _build() -> Optional[str]:
    """Compile to a per-pid temp path and atomically rename — multiple
    worker processes may race to build on first use."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        "-std=c++17", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return _LIB_PATH
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("WFTPU_DISABLE_NATIVE"):
            _lib = False
            return _lib
        path = _LIB_PATH
        if not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(
            _SRC
        ):
            path = _build()
        if path is None:
            _lib = False
            return _lib
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _lib = False
            return _lib
        i64, f32p, f64p = (
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
        )
        lib.affine_trilinear_f32.argtypes = [
            f32p, f32p, i64, i64, i64, f64p, f64p, ctypes.c_float,
        ]
        lib.affine_nearest_f32.argtypes = lib.affine_trilinear_f32.argtypes
        lib.gaussian_blur_f32.argtypes = [
            f32p, f32p, i64, i64, i64, ctypes.c_double,
        ]
        lib.crop_pad_f32.argtypes = [
            f32p, f32p, i64, i64, i64, i64, i64, i64, i64, i64, i64, i64,
            ctypes.c_float,
        ]
        lib.wfdata_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return bool(_load())


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def affine_transform(
    vol: np.ndarray,
    matrix: np.ndarray,
    offset: np.ndarray,
    order: int = 1,
    cval: float = 0.0,
) -> np.ndarray:
    """Native affine resampling of a (D, H, W) float32 volume; order 1
    (trilinear) or 0 (nearest)."""
    lib = _load()
    if not lib:
        from scipy import ndimage

        return ndimage.affine_transform(
            vol, matrix, offset=offset, order=order, mode="constant",
            cval=cval,
        ).astype(np.float32)
    vol = np.ascontiguousarray(vol, np.float32)
    out = np.empty_like(vol)
    m = np.ascontiguousarray(matrix, np.float64).reshape(-1)
    off = np.ascontiguousarray(offset, np.float64)
    fn = lib.affine_trilinear_f32 if order >= 1 else lib.affine_nearest_f32
    fn(_f32p(vol), _f32p(out), *vol.shape, _f64p(m), _f64p(off),
       ctypes.c_float(cval))
    return out


def gaussian_blur(vol: np.ndarray, sigma: float) -> np.ndarray:
    lib = _load()
    if not lib:
        from scipy import ndimage

        return ndimage.gaussian_filter(vol, sigma).astype(np.float32)
    vol = np.ascontiguousarray(vol, np.float32)
    out = np.empty_like(vol)
    lib.gaussian_blur_f32(_f32p(vol), _f32p(out), *vol.shape,
                          ctypes.c_double(sigma))
    return out


def crop_pad(
    vol: np.ndarray, corner, patch, fill: float = 0.0
) -> np.ndarray:
    """Extract (C, *patch) from (C, D, H, W) with constant fill OOB."""
    lib = _load()
    vol = np.ascontiguousarray(vol, np.float32)
    if not lib:
        c = vol.shape[0]
        out = np.full((c, *patch), fill, np.float32)
        src = [slice(max(0, corner[d]), min(vol.shape[1 + d], corner[d] + patch[d]))
               for d in range(3)]
        dst = [slice(src[d].start - corner[d], src[d].stop - corner[d])
               for d in range(3)]
        out[(slice(None), *dst)] = vol[(slice(None), *src)]
        return out
    out = np.empty((vol.shape[0], *patch), np.float32)
    lib.crop_pad_f32(
        _f32p(vol), _f32p(out), vol.shape[0], vol.shape[1], vol.shape[2],
        vol.shape[3], int(corner[0]), int(corner[1]), int(corner[2]),
        int(patch[0]), int(patch[1]), int(patch[2]), ctypes.c_float(fill),
    )
    return out


def num_threads() -> int:
    lib = _load()
    return int(lib.wfdata_num_threads()) if lib else 1
