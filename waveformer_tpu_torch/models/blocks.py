"""WaveFormer transformer block: DWT-compressed multi-scale window attention.

Port of `waveformer_tpu/models/blocks.py` (reference `Block`,
`network_models/wave_helper.py:357-549`). The multi-scale forward
Haar-decomposes the pre-norm features level by level, runs shared-weight
window attention on each low-frequency grid, resizes each scale's output
back to the stage grid and sums them. The high-frequency details come back
coarsest first, ready for `waverec3`. With a `depth_shard` the block holds
a D slab: a grid whose slab is a whole number of windows deep attends
locally, a coarser one is gathered along D, attended whole and cut back to
this rank's planes, and the resizes take global source planes
(`parallel/spatial.py`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from waveformer_tpu_torch.models.attention import WindowAttention
from waveformer_tpu_torch.models.common import DropPath
from waveformer_tpu_torch.models.layers import CCF_FFN
from waveformer_tpu_torch.ops.wavelet import dwt3, wavedec3
from waveformer_tpu_torch.ops.window import window_partition, window_unpartition_flat
from waveformer_tpu_torch.parallel import spatial

HFDetails = Dict[str, torch.Tensor]


class WaveFormerBlock(nn.Module):
    """One transformer block; `forward` returns `(x, hfs)`."""

    depth_shard = None  # this rank's `spatial` line, set by `shard_model`

    def __init__(
        self,
        dim: int,
        num_heads: int,
        level: int,
        img_size: Tuple[int, int, int],
        mlp_ratio: float = 4.0,
        ms_attention: bool = True,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        drop_path: float = 0.0,
        norm_eps: float = 1e-6,
    ):
        super().__init__()
        self.level = level
        self.img_size = tuple(img_size)
        self.ms_attention = ms_attention
        self.window_size = self.img_size[0] // (2**level)
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = WindowAttention(
            dim, num_heads, self.window_size, qkv_bias=qkv_bias, qk_scale=qk_scale
        )
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = CCF_FFN(dim, int(dim * mlp_ratio))

    def _attend(self, h: torch.Tensor) -> torch.Tensor:
        shard = self.depth_shard
        straddles = shard is not None and h.shape[1] % self.window_size != 0
        if straddles:
            h = spatial.gather_depth(h, shard)
        grid = tuple(h.shape[1:4])
        attn_w = self.attn(window_partition(h, self.window_size))
        out = window_unpartition_flat(attn_w, self.window_size, grid)
        return spatial.own_planes(out, shard) if straddles else out

    def _resize(self, v: torch.Tensor) -> torch.Tensor:
        return spatial.resize_trilinear(v, self.img_size, False, self.depth_shard)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Tuple[HFDetails, ...]]:
        shortcut = x
        h = self.norm1(x)
        hfs: List[HFDetails] = []
        if self.ms_attention:
            attn_fused = None
            for _ in range(max(self.level, 1)):
                if self.level > 0:
                    h, det = dwt3(h)
                    hfs.append(det)
                attn_vol = self._attend(h)
                if self.level > 0:
                    attn_vol = self._resize(attn_vol)
                attn_fused = attn_vol if attn_fused is None else attn_fused + attn_vol
        else:
            # single-scale variant (`wave_helper.py:515-549`)
            if self.level > 0:
                coeffs = wavedec3(h, level=self.level)
                h, hfs = coeffs[0], list(coeffs[1:])
            attn_fused = self._attend(h)
            if self.level > 0:
                attn_fused = self._resize(attn_fused)

        x = shortcut + self.drop_path(attn_fused, generator)
        x = x + self.drop_path(self.mlp(self.norm2(x)), generator)
        if self.level > 0:
            # the reference reverses the per-scale list: coarsest first
            return x, (tuple(reversed(hfs)) if self.ms_attention else tuple(hfs))
        return x, ()
