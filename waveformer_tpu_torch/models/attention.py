"""Windowed multi-head self-attention with 3D relative position bias.

Port of `waveformer_tpu/models/attention.py` (reference
`network_models/attention.py:15-104`). The relative-position index keeps
the reference's nonstandard strides (3w−1 for depth, 2w−1 for height,
`attention.py:43-44`): released checkpoints bake them into the bias table.
Every call goes through `ops.attention_cuda.window_attention`.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from waveformer_tpu_torch.ops.attention_cuda import window_attention


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: int) -> np.ndarray:
    """(N, N) int32 index into the (2w−1)³ bias table, N = window_size³."""
    ws = window_size
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), np.arange(ws), indexing="ij")
    )
    coords_flatten = coords.reshape(3, -1)
    rel = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel += ws - 1
    rel[:, :, 0] *= 3 * ws - 1  # reference quirk: not (2w−1)²
    rel[:, :, 1] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int32)


class WindowAttention(nn.Module):
    """MHSA over flattened windows: (B·nW, N, C) → (B·nW, N, C).

    The bias table stays fp32 whatever the compute dtype, as the JAX
    package keeps its parameters (see `Waveformer.set_compute_dtype`)."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        window_size: int,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
    ):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        hd = dim // num_heads
        self.scale = qk_scale if qk_scale is not None else hd**-0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 3, num_heads)
        )
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size).astype(np.int64)),
        )

    def bias(self) -> torch.Tensor:
        """(H, N, N) fp32 bias gathered from the table."""
        n = self.window_size**3
        idx = self.relative_position_index.reshape(-1)
        table = self.relative_position_bias_table.float()
        return table[idx].reshape(n, n, self.num_heads).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        out = window_attention(qkv[0], qkv[1], qkv[2], self.bias(), self.scale)
        out = out.transpose(1, 2).reshape(b, n, c)
        return self.proj(out)
