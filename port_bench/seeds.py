"""Independent streams from one `--seed`: the weights, the cases, the
sample that the check takes, each from its own hash of (seed, stream)."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for `stream` of `seed` (any whole number, negative or
    above 64 bits included)."""
    words = [int(seed) % 2 ** 64, zlib.crc32(stream.encode())]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)
