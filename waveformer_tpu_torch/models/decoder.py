"""IDWT decoder blocks (reference `network_models/idwt_upsample.py`).

Port of `waveformer_tpu/models/decoder.py`, channels-last layout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from waveformer_tpu_torch.models.common import ConvCL, Convolution, InstanceNormAffine
from waveformer_tpu_torch.models.conv_blocks import _res_or_basic
from waveformer_tpu_torch.ops.wavelet import waverec3


class HFRefinementRes(nn.Module):
    """Gated HF filtering before the IDWT (`idwt_upsample.py:12-50`):
    dw 3³ conv (the stencil kernel) → IN(affine) → ReLU → 1³ conv →
    sigmoid, multiplied onto the input."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv1 = ConvCL(c, c, 3, padding=1, groups=c)
        self.norm = InstanceNormAffine(c)
        self.conv2 = ConvCL(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.relu(self.norm(self.conv1(x)))
        return x * torch.sigmoid(self.conv2(g))


class UnetrIDWTBlock(nn.Module):
    """IDWT upsampling decoder block (`idwt_upsample.py:53-165`):
    3³ conv on the LF input → optional per-level HF refinement →
    `waverec3([lf, *hf])` → concat the encoder skip → res (or basic) block.
    `stage` is the number of HF levels consumed."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        stage: int,
        hf_refinement: bool = False,
        kernel_size: int = 3,
        res_block: bool = True,
    ):
        super().__init__()
        self.conv_lf_block = Convolution(in_channels, out_channels, kernel_size)
        self.hf_ref = (
            nn.ModuleList(HFRefinementRes(out_channels) for _ in range(stage))
            if hf_refinement
            else None
        )
        self.conv_block = _res_or_basic(
            res_block, 2 * out_channels, out_channels, kernel_size
        )

    def forward(
        self, inp: torch.Tensor, skip: torch.Tensor, hf_coeffs: Sequence[dict]
    ) -> torch.Tensor:
        lf = self.conv_lf_block(inp)
        if self.hf_ref is not None:
            hf_coeffs = [
                {k: ref(v) for k, v in det.items()}
                for ref, det in zip(self.hf_ref, hf_coeffs)
            ]
        out = waverec3([lf] + list(hf_coeffs))
        return self.conv_block(torch.cat([out, skip], dim=-1))
