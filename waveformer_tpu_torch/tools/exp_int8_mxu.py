"""A/B probe: do int8 matrix products run faster than bf16 ones on this card?

Counterpart of the repository's `tools/exp_int8_mxu.py`; the name keeps
"mxu", the TPU's matrix unit. It answers whether an int8 serving mode could
pay for itself.

    python -m waveformer_tpu_torch.tools.exp_int8_mxu [--iters 64] [--device cuda] [--back-to-back]

For each of the JAX probe's three (M, K, N, BM) shapes it runs bf16 → fp32
(input perturbed) and int8 → int32 (output perturbed) through
`ops/tiled_matmul_cuda.make`, on inputs from `numpy.random.default_rng(0)`
drawn in the JAX script's order, and prints one JSON line per shape and
type: the kernel's µs per call (`utils/profiling.device_time`: on the
device, the calls queued behind a device sleep; with `--back-to-back`, as
fast as the host issues them, its work per call included), its TOP/s,
the card's bound in µs, the µs of one library call computing the same
product (`torch.mm(x, w, out_dtype=torch.float32)` for bf16,
`torch._int_mm(x, w)` for int8: yardsticks only, never on the port's path),
and the int8/bf16 speed ratios of the kernels and of the library calls.
Importing the module runs nothing.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Sequence, Tuple

import numpy as np
import torch

from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.ops.tiled_matmul_cuda import make
from waveformer_tpu_torch.utils.profiling import device_time

# (M, K, N, BM) of the JAX probe
SHAPES = [(32768, 1024, 512, 1024), (32768, 1024, 512, 512), (16384, 2048, 512, 512)]
# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
TENSOR_OPS = {"bf16": 989e12, "int8": 1979e12}
KINDS = {"bf16": (torch.bfloat16, torch.float32, False),  # in, out, perturb_out
         "int8": (torch.int8, torch.int32, True)}
# the PyTorch call that computes each product (CUDA only), and its label
LIBRARY = {"bf16": (lambda x, w: torch.mm(x, w, out_dtype=torch.float32),
                    "torch.mm(out_dtype=float32)"),
           "int8": (torch._int_mm, "torch._int_mm")}


def bound_us(m: int, k: int, n: int, kind: str) -> Tuple[float, str]:
    """(µs, "bytes" or "operations"): each input and output byte once at the
    HBM rate, or the products at the dense tensor rate, whichever is longer."""
    es = 2 if kind == "bf16" else 1
    t_bytes = ((m * k + k * n) * es + m * n * 4) / HBM_BYTES_PER_S * 1e6
    t_ops = 2 * m * k * n / TENSOR_OPS[kind] * 1e6
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _inputs(rng: np.random.Generator, m: int, k: int, n: int, kind: str, dev: torch.device):
    if kind == "bf16":
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.standard_normal((k, n)).astype(np.float32)
    else:
        x = rng.integers(-127, 127, (m, k)).astype(np.int8)
        w = rng.integers(-127, 127, (k, n)).astype(np.int8)
    dt = KINDS[kind][0]
    return (torch.from_numpy(x).to(dev).to(dt), torch.from_numpy(w).to(dev).to(dt))


def run(shapes: Sequence[Tuple[int, int, int, int]] = SHAPES, iters: int = 64,
        device=None, back_to_back: bool = False) -> List[dict]:
    """Time both kernels at `shapes`; one row per shape and type."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    rows = []
    for m, k, n, bm in shapes:
        pair = {}
        for kind, (_, out_dtype, perturb_out) in KINDS.items():
            x, w = _inputs(rng, m, k, n, kind, dev)
            mm = make(m, k, n, bm, out_dtype, perturb_out)
            s0 = torch.zeros(8, dtype=torch.float32, device=dev)
            t = device_time(lambda s, x=x, w=w, mm=mm: mm(s, x, w), s0, iters=iters,
                            behind_sleep=not back_to_back)
            lib, lib_name = LIBRARY[kind]
            lib_t = None
            if dev.type == "cuda":
                lib_t = device_time(lambda s, x=x, w=w: lib(x, w), s0, iters=iters,
                                    behind_sleep=not back_to_back)
            b_us, b_by = bound_us(m, k, n, kind)
            pair[kind] = {
                "M": m, "K": k, "N": n, "BM": bm, "dtype": kind, "device": name,
                "timing": "back_to_back" if back_to_back else "device",
                "us": t * 1e6, "top_s": 2 * m * k * n / t / 1e12,
                "bound_us": b_us, "bound_by": b_by,
                "library_us": None if lib_t is None else lib_t * 1e6,
                "library_call": lib_name,
            }
            del x, w
        ratio = pair["bf16"]["us"] / pair["int8"]["us"]
        lib_ratio = (pair["bf16"]["library_us"] / pair["int8"]["library_us"]
                     if dev.type == "cuda" else None)
        for row in pair.values():
            row.update({"int8_speedup_kernel": ratio, "int8_speedup_library": lib_ratio})
            rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--back-to-back", action="store_true",
                    help="time the calls as the host issues them, without the device sleep")
    args = ap.parse_args(argv)
    for row in run(iters=args.iters, device=args.device, back_to_back=args.back_to_back):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
