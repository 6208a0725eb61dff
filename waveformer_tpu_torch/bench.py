"""Benchmark entry point: the serving protocol of the repository's
`bench.py`, on one CUDA card. Prints the headline JSON line first.

    python -m waveformer_tpu_torch.bench [--device cuda|cpu] [--config PATH]

Headline metric: BraTS2023 full-case sliding-window inference throughput,
cases/s on one card. The protocol: the flagship WaveFormer (`Config()`, or
the network of `--config`) in the config's compute dtype (bf16 for the
flagship) with seed-0 weights, channels-first model and inferer, roi =
the prediction patch size (128³), sw_batch 8, overlap 0.5, Gaussian
blending, 8-way mirror TTA folded into the patch predictor; one warm-up
case of (4, 150, 180, 145), then 3 streams of 4 such cases through
`Predictor.predict_cases`. `value` is the mean of the last two streams.

Baseline anchor: 1.92 cases/s, the strongest published single-GPU
transformer-core rate on this workload (BASELINE.md), measured without TTA
on an A100; the 8×-TTA number reported here makes `vs_baseline`
conservative.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from waveformer_tpu_torch.config import Config, load_config
from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.inference import Predictor, SlidingWindowInferer
from waveformer_tpu_torch.models import Waveformer, create_waveformer

BASELINE_CASES_PER_S = 1.92
CASE_SHAPE = (4, 150, 180, 145)  # a typical post-crop BraTS case; bucket 192³
SEED = 0
STREAM_CASES = 4
SW_BATCH_SIZE = 8
OVERLAP = 0.5
MIRROR_AXES = (0, 1, 2)
N_STREAMS = 3


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def setup(cfg: Optional[Config] = None, device=None,
          mirror_axes: Optional[Tuple[int, ...]] = MIRROR_AXES) -> Tuple[Waveformer, Predictor]:
    """The protocol's seed-0 model and its predictor (channels-first, patch
    TTA over `mirror_axes`: 8-way by default, none for None) on `device`
    (the CUDA device unless asked otherwise)."""
    cfg = cfg or Config()
    dtype = compute_dtype(cfg)
    model = create_waveformer(cfg.network.model_kwargs(), dtype=dtype, device=device,
                              seed=SEED, io_layout="channels_first")
    inferer = SlidingWindowInferer(
        roi_size=cfg.prediction.patch_size,
        sw_batch_size=SW_BATCH_SIZE,
        overlap=OVERLAP,
        mirror_axes=mirror_axes,
        layout="channels_first",
        tta_mode="patch",
    )
    return model, Predictor(inferer, upload_dtype=dtype, device=device)


def stream_rate(predictor: Predictor, model: Waveformer, vols, out_channels: int) -> float:
    """Cases/s of one pipelined stream; each label map reaches the host."""
    t0 = time.time()
    for vol, seg in zip(vols, predictor.predict_cases(vols, model, out_channels)):
        if seg.shape != vol.shape[1:]:
            raise RuntimeError(f"label map {seg.shape} for a case of {vol.shape}")
    return len(vols) / (time.time() - t0)


def main(argv=None, case_shape=CASE_SHAPE, stream_cases=STREAM_CASES) -> dict:
    """Run the protocol and print its headline line; returns the line. The
    case shape and stream length are the protocol's unless a caller (a test
    at a tiny size) passes others."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--config", default=None,
                    help="config file (default: the flagship, Config())")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config) if args.config else Config()
    model, predictor = setup(cfg, device)
    out_channels = cfg.network.out_channels

    rng = np.random.default_rng(SEED)
    shape = tuple(case_shape)
    warm = rng.standard_normal(shape).astype(np.float32)
    if predictor.predict_case(warm, model, out_channels).shape != shape[1:]:
        raise RuntimeError("warm-up case: wrong label-map shape")
    vols = [rng.standard_normal(shape).astype(np.float32) for _ in range(stream_cases)]
    # the first stream after the warm-up pays one-off costs; the headline is
    # the mean of the two warm streams
    rates = [stream_rate(predictor, model, vols, out_channels) for _ in range(N_STREAMS)]
    cases_per_s = (rates[1] + rates[2]) / 2.0

    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    roi = "x".join(str(r) for r in cfg.prediction.patch_size)
    dtype = "bf16" if compute_dtype(cfg) == torch.bfloat16 else "fp32"
    line = {
        "metric": "brats_fullcase_sliding_window_inference",
        "value": round(cases_per_s, 4),
        "unit": f"cases/sec/card ({card}; {roi} roi, overlap {OVERLAP}, "
                f"{2 ** len(MIRROR_AXES)}x mirror TTA, {dtype})",
        "vs_baseline": round(cases_per_s / BASELINE_CASES_PER_S, 4),
        "streams": [round(r, 4) for r in rates],
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
