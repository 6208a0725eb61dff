"""Serving throughput against the number of mirror-TTA orientations: the
repository's `tools/bench_tta.py` for the port.

    python -m waveformer_tpu_torch.tools.bench_tta [--tta 1 2 4 8] [--cases 4]
        [--device cuda|cpu]

For each of 1, 2, 4 and 8 orientations (mirror axes none, (0,), (0, 1) and
(0, 1, 2)) it runs `bench.py`'s protocol through `bench.setup` (the
flagship in bf16 with seed-0 weights, channels-first, roi 128³, sw_batch 8,
overlap 0.5, patch-mode TTA) and `bench.stream_rate`: one warm-up case,
then 3 pipelined streams of `--cases` seeded (4, 150, 180, 145) cases, the
headline the mean of the last two. One JSON line per setting, printed as
it is measured: `tta`, `cases_per_s_chip` (cases/s on the one card),
`s_per_case`, `streams`, and `warmup_s`, the warm-up case's seconds.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from waveformer_tpu_torch import bench
from waveformer_tpu_torch.config import Config
from waveformer_tpu_torch.device import resolve_device

# mirror axes of each number of orientations (`tools/bench_tta.py:60`)
AXES = {1: None, 2: (0,), 4: (0, 1), 8: (0, 1, 2)}


def main(argv=None, case_shape=bench.CASE_SHAPE, cfg: Optional[Config] = None,
         weights=None) -> Tuple[List[dict], Dict[int, np.ndarray]]:
    """Run every asked setting and print its line. Returns the lines and,
    by setting, the warm-up case's label map. The case shape, config and
    weights (a state dict) are the protocol's unless a caller (a test at a
    tiny size) passes others."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tta", type=int, nargs="*", default=[1, 2, 4, 8], choices=sorted(AXES))
    ap.add_argument("--cases", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = cfg or Config()
    out_channels = cfg.network.out_channels
    rng = np.random.default_rng(bench.SEED)
    shape = tuple(case_shape)
    vols = [rng.standard_normal(shape).astype(np.float32) for _ in range(args.cases)]
    lines, labels = [], {}
    for n_tta in args.tta:
        model, predictor = bench.setup(cfg, device, mirror_axes=AXES[n_tta])
        if weights is not None:
            model.load_state_dict(weights, strict=True)
        t0 = time.time()
        labels[n_tta] = predictor.predict_case(vols[0], model, out_channels)
        warmup_s = time.time() - t0
        if labels[n_tta].shape != shape[1:]:
            raise RuntimeError(f"warm-up case: label map {labels[n_tta].shape}")
        rates = [bench.stream_rate(predictor, model, vols, out_channels)
                 for _ in range(bench.N_STREAMS)]
        cases_per_s = (rates[1] + rates[2]) / 2.0
        line = {"tta": n_tta, "cases_per_s_chip": cases_per_s, "s_per_case": 1.0 / cases_per_s,
                "streams": rates, "warmup_s": warmup_s}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del model, predictor
    return lines, labels


if __name__ == "__main__":
    main()
