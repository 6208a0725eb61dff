"""What the serving kinds share: the system's predictor, built from its
public classes as a user builds it; the cases, made from the seed; and the
check of the label maps it served against the plain reference.

The check: a sample of the served cases, drawn from the seed, each of a
different volume of the ring. The reference computes each volume's float32
logits through its own Gaussian sliding window with mirror TTA, and the
number compared is the widest gap by which a served voxel's logit lies
below the reference's best logit there (`gap_max`). A label map of the
wrong shape is a failed case.
"""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from port_bench import seeds
from port_bench.reference.lowp import fp8_round, plain_precision
from port_bench.reference.serve import predict_logits, widest_gap
from port_bench.trace import MODEL_SPAN, Span

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def mirror_axes(tta: int):
    """The mirror axes of `tta` orientations (1, 2, 4 or 8)."""
    n = {1: 0, 2: 1, 4: 2, 8: 3}[int(tta)]
    return tuple(range(n)) or None


class Served:
    """The system's model and predictor for a serving cell."""

    def __init__(self, ctx):
        from waveformer_tpu_torch.inference import Predictor, SlidingWindowInferer

        cfg, serving = ctx.config, ctx.config["serving"]
        dtype = DTYPES[cfg["compute_dtype"]]
        self.model = ctx.arch.system(cfg["network"], dtype, ctx.device,
                                     io_layout="channels_first")
        self.model.load_state_dict(ctx.state_dict)
        inferer = SlidingWindowInferer(
            roi_size=serving["roi"], sw_batch_size=serving["sw_batch_size"],
            overlap=serving["overlap"], mirror_axes=mirror_axes(ctx.traffic["tta"]),
            layout="channels_first", tta_mode="patch")
        self.predictor = Predictor(inferer, upload_dtype=dtype, device=ctx.device)
        self.span = Span(MODEL_SPAN, self.model)
        self.out_channels = ctx.arch.io(cfg["network"])[1]

    def release(self) -> None:
        self.model = self.predictor = self.span = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def make_cases(ctx) -> List[np.ndarray]:
    """The ring of float32 volumes (C, D, H, W), unit-normal, made on the
    device from the seed and handed over on the host, as a user's
    preprocessed cases arrive."""
    shape = tuple(ctx.config["serving"]["case_shape"])
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(seeds.derive(ctx.seed, "cases"))
    ring = torch.randn((ctx.traffic["ring"], *shape), generator=gen, device=ctx.device)
    return [v.cpu().numpy() for v in ring]


def sample(ctx, served: Dict[int, np.ndarray], ring: int) -> List[int]:
    """Indices of served cases to check: `check_cases` of them, drawn from
    the seed, each of another volume of the ring."""
    rng = np.random.default_rng(seeds.derive(ctx.seed, "sample"))
    by_volume: Dict[int, List[int]] = {}
    for i in sorted(served):
        by_volume.setdefault(i % ring, []).append(i)
    volumes = sorted(by_volume)
    k = min(int(ctx.traffic["check_cases"]), len(volumes))
    return [int(rng.choice(by_volume[int(v)])) for v in rng.choice(volumes, k, replace=False)]


def reference(ctx, rounding=None):
    """The float32 reference model, or the control with `rounding`."""
    model = ctx.arch.build(ctx.config["network"], ctx.device)
    model.load_state_dict(ctx.state_dict)
    model.eval()
    if rounding is not None:
        ctx.arch.set_rounding(model, rounding)
    return model


def reference_logits(ctx, model, volume: np.ndarray) -> torch.Tensor:
    serving = ctx.config["serving"]
    vol = torch.from_numpy(volume).to(ctx.device)
    with torch.no_grad(), plain_precision():
        return predict_logits(model, vol, ctx.arch.io(ctx.config["network"])[1], serving["roi"],
                              serving["overlap"], int(ctx.traffic["check_batch"]),
                              mirror_axes(ctx.traffic["tta"]) or ())


def check(ctx, cases: List[np.ndarray], served: Dict[int, np.ndarray]) -> Dict[str, float]:
    """{"gap_max": the widest logit gap over the sampled cases}."""
    model = reference(ctx)
    gaps = []
    for i in sample(ctx, served, len(cases)):
        logits = reference_logits(ctx, model, cases[i % len(cases)])
        labels = torch.from_numpy(np.ascontiguousarray(served[i])).to(ctx.device)
        gaps.append(widest_gap(logits, labels))
        del logits
    return {"gap_max": max(gaps) if gaps else float("inf")}


def control(ctx, cases: List[np.ndarray], served: Dict[int, np.ndarray]) -> Dict[str, float]:
    """The check's number for the control: the reference in float8 in the
    system's place, its labels on the same sampled cases judged by the
    float32 reference."""
    exact, lowp = reference(ctx), reference(ctx, fp8_round)
    gaps = []
    for i in sample(ctx, served, len(cases)):
        volume = cases[i % len(cases)]
        labels = reference_logits(ctx, lowp, volume).argmax(dim=0)
        gaps.append(widest_gap(reference_logits(ctx, exact, volume), labels))
    return {"gap_max": max(gaps) if gaps else float("inf")}
