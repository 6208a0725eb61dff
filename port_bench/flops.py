"""Operations and bytes, counted from the reference and from call shapes,
never from the system under test: the yardstick of `mfu.*` and of the
kernels' roofline shares.

`model_counts(arch, network, batch)` asks the architecture's module
(`port_bench/archs/`) once per configuration and batch for its forward's
FLOPs (the plain reference traced on the "meta" device by
`torch.utils.flop_counter.FlopCounterMode`: shapes only, no arithmetic) and
the shape of every call that a roofline metric reads. A training step is
taken as three forwards (the backward of a product costs two: the input's
gradient and the weight's); FlopCounterMode's own backward count is not
used, because it counts a grouped convolution's backward without dividing
by the groups (33× its forward at 32 channels).
"""

from __future__ import annotations

import json
from types import ModuleType
from typing import Dict, Tuple

BF16_BYTES = 2
FP32_BYTES = 4

# forward counts by (architecture, configuration, batch)
_COUNTS: Dict[Tuple[str, str, int], Tuple[int, Tuple]] = {}


def model_counts(arch: ModuleType, network: Dict, batch: int = 1) -> Dict:
    """{"forward_flops", "train_flops", "calls": [(kernel, shape), ...]} of
    one forward of `batch` patches."""
    key = (arch.__name__, json.dumps(network, sort_keys=True), batch)
    if key not in _COUNTS:
        flops, calls = arch.forward_counts(network, batch)
        _COUNTS[key] = (flops, tuple(calls))
    flops, calls = _COUNTS[key]
    return {"forward_flops": flops, "train_flops": 3 * flops, "calls": list(calls)}


def attention_work(shape) -> Tuple[float, float]:
    """(FLOPs, bytes) of one bf16 window-attention call on q of shape
    (windows, heads, N, D): QKᵀ and PV are 2·N²·D each per window and head;
    q, k, v and the output are read or written once in bf16, the (heads, N,
    N) bias once in fp32."""
    w, h, n, d = shape
    flops = 4.0 * n * n * d * w * h
    nbytes = 4.0 * w * h * n * d * BF16_BYTES + h * n * n * FP32_BYTES
    return flops, nbytes


def dwconv3_work(shape) -> Tuple[float, float]:
    """(FLOPs, bytes) of one bf16 depthwise 3³ stencil on x (B, D, H, W, C):
    27 multiply-adds a voxel and channel; x and the output once in bf16,
    the (3, 3, 3, C) taps and the bias once in fp32."""
    b, d, h, w, c = shape
    voxels = b * d * h * w
    flops = 2.0 * 27 * voxels * c
    nbytes = 2.0 * voxels * c * BF16_BYTES + 28 * c * FP32_BYTES
    return flops, nbytes


WORK = {"window_attention": attention_work, "dwconv3": dwconv3_work}


def bound_seconds(kernel: str, calls, flops_per_s: float, bytes_per_s: float) -> float:
    """The least time the chip needs for `kernel`'s calls among `calls`:
    per call the larger of its FLOPs over the product rate and its bytes
    over the memory rate."""
    total = 0.0
    for name, shape in calls:
        if name == kernel:
            f, b = WORK[kernel](shape)
            total += max(f / flops_per_s, b / bytes_per_s)
    return total
