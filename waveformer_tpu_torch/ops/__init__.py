"""Ops of the port: wavelets, windows, resize, the kernels' entry points and
the auxiliary ops (grid pull/push, bilateral filters, GMM, criss-cross
attention)."""

from waveformer_tpu_torch.ops.attention_cuda import window_attention
from waveformer_tpu_torch.ops.bilateral import (
    TrainableBilateralFilter,
    bilateral_filter,
    joint_bilateral_filter,
)
from waveformer_tpu_torch.ops.cc_attention import criss_cross_attention
from waveformer_tpu_torch.ops.dwconv_cuda import dwconv3
from waveformer_tpu_torch.ops.gmm import GMMParams, gmm_fit, gmm_posterior, gmm_segment
from waveformer_tpu_torch.ops.resize import resize_trilinear
from waveformer_tpu_torch.ops.spatial import grid_count, grid_pull, grid_push
from waveformer_tpu_torch.ops.wavelet import (
    DETAIL_KEYS,
    dwt3,
    idwt3,
    register_wavelet,
    wavedec3,
    waverec3,
)
from waveformer_tpu_torch.ops.window import (
    window_partition,
    window_unpartition,
    window_unpartition_flat,
)

__all__ = [
    "DETAIL_KEYS",
    "GMMParams",
    "TrainableBilateralFilter",
    "bilateral_filter",
    "criss_cross_attention",
    "dwconv3",
    "dwt3",
    "gmm_fit",
    "gmm_posterior",
    "gmm_segment",
    "grid_count",
    "grid_pull",
    "grid_push",
    "idwt3",
    "joint_bilateral_filter",
    "register_wavelet",
    "resize_trilinear",
    "wavedec3",
    "waverec3",
    "window_attention",
    "window_partition",
    "window_unpartition",
    "window_unpartition_flat",
]
