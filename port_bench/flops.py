"""Operations and bytes, counted from the reference and from call shapes,
never from the system under test: the yardstick of `mfu.*` and of the
kernels' roofline shares.

`model_counts(network, batch)` traces the plain reference once on the
"meta" device (shapes only, no arithmetic): its forward's FLOPs by
`torch.utils.flop_counter.FlopCounterMode`, and the shape of every
window-attention and depthwise-stencil call. A training step is taken as
three forwards (the backward of a product costs two: the input's gradient
and the weight's); FlopCounterMode's own backward count is not used,
because it counts a grouped convolution's backward without dividing by
the groups (33× its forward at 32 channels).
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference.model import build, set_probe

BF16_BYTES = 2
FP32_BYTES = 4


@functools.lru_cache(maxsize=None)
def _counts(network_json: str, batch: int) -> Tuple[int, Tuple]:
    network = json.loads(network_json)
    model = build(network, "meta")
    x = torch.empty((batch, *network["img_size"], network["in_chans"]), device="meta")
    calls: List = []
    set_probe(model, calls)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops(), tuple(calls)


def model_counts(network: Dict, batch: int = 1) -> Dict:
    """{"forward_flops", "train_flops", "calls": [(kernel, shape), ...]} of
    one forward of `batch` patches."""
    flops, calls = _counts(json.dumps(network, sort_keys=True), batch)
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
