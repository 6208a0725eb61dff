"""Sliding-window inference with mirror TTA, and the full-case predictor."""

from waveformer_tpu_torch.inference.predictor import Predictor, largest_connected_component
from waveformer_tpu_torch.inference.sliding_window import (
    SlidingWindowInferer,
    sliding_window_inference,
)

__all__ = [
    "Predictor",
    "SlidingWindowInferer",
    "largest_connected_component",
    "sliding_window_inference",
]
