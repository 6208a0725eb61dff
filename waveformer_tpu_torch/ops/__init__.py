"""Ops of the port: Haar wavelets, windows, resize and the two kernels."""

from waveformer_tpu_torch.ops.attention_cuda import window_attention
from waveformer_tpu_torch.ops.dwconv_cuda import dwconv3
from waveformer_tpu_torch.ops.resize import resize_trilinear
from waveformer_tpu_torch.ops.wavelet import (
    DETAIL_KEYS,
    dwt3,
    idwt3,
    wavedec3,
    waverec3,
)
from waveformer_tpu_torch.ops.window import window_partition, window_unpartition_flat

__all__ = [
    "DETAIL_KEYS",
    "dwconv3",
    "dwt3",
    "idwt3",
    "resize_trilinear",
    "wavedec3",
    "waverec3",
    "window_attention",
    "window_partition",
    "window_unpartition_flat",
]
