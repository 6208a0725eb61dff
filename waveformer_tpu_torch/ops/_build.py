"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into
`waveformer_tpu_torch/_build/<name>-<hash>.so`, where the hash covers the
source and the flags, so an edited source rebuilds and an unchanged one
is reused. The sources have a plain C interface (no PyTorch headers), so a
build takes seconds. `build_all()` starts one nvcc per source at once.

There is no fallback: without nvcc, a build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from source at first use"
        )
    return found


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


class KernelLibraries:
    """Built and loaded kernel libraries, one per `csrc/*.cu` source."""

    def __init__(self):
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()
        self.build_log: Dict[str, str] = {}

    def build_all(self, names: List[str] = None) -> None:
        """Compile every missing library, one nvcc process per source, all
        started together; raise with the compiler output on failure."""
        names = names or sources()
        todo = [n for n in names if not os.path.exists(_lib_path(n))]
        if not todo:
            return
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for n in todo:
            out = _lib_path(n)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
            p = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((n, p, tmp, out))
        errors = []
        for n, p, tmp, out in procs:
            log, _ = p.communicate()
            self.build_log[n] = log
            if p.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{log}")
                continue
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            lib = self._libs.get(name)
            if lib is None:
                self.build_all([name])
                lib = ctypes.CDLL(_lib_path(name))
                self._libs[name] = lib
            return lib


LIBRARIES = KernelLibraries()


def aligned16(t):
    """`t` contiguous and 16-byte aligned (the kernels load 16-byte vectors),
    copied only where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero `cudaError_t`."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
