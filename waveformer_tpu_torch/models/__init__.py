"""The WaveFormer model, ported module by module from waveformer_tpu.models."""

from waveformer_tpu_torch.models.waveformer import (
    MultiscaleTransformer,
    Waveformer,
    create_waveformer,
)

__all__ = ["MultiscaleTransformer", "Waveformer", "create_waveformer"]
