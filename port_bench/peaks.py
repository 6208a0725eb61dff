"""Published peaks of the cards the benchmark knows, by the name
`torch.cuda.get_device_name()` gives: dense bf16 tensor FLOP/s and HBM
bytes/s from NVIDIA's data sheet, at the card's full power limit. A card
not listed has no peak, and the shares of a peak are then left out."""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    # H100 SXM5: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3, 700 W
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)
