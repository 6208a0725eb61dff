"""The port's segmentation models: WaveFormer, ported module by module from
waveformer_tpu.models, and Swin UNETR / SwinUNETR-V2 (MONAI's), built by
`create_model` from a `NetworkConfig`'s `model_type`."""

from __future__ import annotations

from typing import Optional, Union

import torch

from waveformer_tpu_torch.models.swin_unetr import SwinUNETR, create_swin_unetr
from waveformer_tpu_torch.models.waveformer import (
    MultiscaleTransformer,
    Waveformer,
    create_waveformer,
)

# `NetworkConfig.model_type` → the constructor `create_model` calls
MODELS = {"Waveformer": create_waveformer, "SwinUNETR": create_swin_unetr}


def create_model(network_config, dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: Optional[int] = None, **overrides) -> torch.nn.Module:
    """The model a `NetworkConfig` names, from its `model_kwargs()`, as its
    constructor builds it (eval mode, `dtype`, `device`, `seed`; keyword
    overrides such as `io_layout`)."""
    name = network_config.model_type
    if name not in MODELS:
        raise ValueError(f"unknown model_type {name!r}: the port builds {', '.join(MODELS)}")
    return MODELS[name](network_config.model_kwargs(), dtype=dtype, device=device, seed=seed,
                        **overrides)


__all__ = ["MODELS", "MultiscaleTransformer", "SwinUNETR", "Waveformer", "create_model",
           "create_swin_unetr", "create_waveformer"]
