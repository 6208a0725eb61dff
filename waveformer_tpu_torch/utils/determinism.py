"""Determinism seeding (reference `monai.utils.set_determinism`,
`monai/utils/misc.py:316`, called with 123 at `3_train.py:20`).

A copy of `waveformer_tpu/utils/determinism.py`: seeds Python's `random`
and numpy's global generator as the JAX package does, and also torch's
generators (`torch.manual_seed`, which covers every CUDA device), and
records the global seed.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

_GLOBAL_SEED: Optional[int] = None


def set_determinism(seed: Optional[int] = 123) -> None:
    global _GLOBAL_SEED
    _GLOBAL_SEED = seed
    if seed is not None:
        np.random.seed(seed % (2**32))
        random.seed(seed)
        torch.manual_seed(seed)


def get_seed() -> Optional[int]:
    return _GLOBAL_SEED
