"""Windowed multi-head self-attention with 3D relative position bias.

Port of `waveformer_tpu/models/attention.py` (reference
`network_models/attention.py:15-104`). The relative-position index keeps
the reference's nonstandard strides (3w−1 for depth, 2w−1 for height,
`attention.py:43-44`): released checkpoints bake them into the bias table.
Swin UNETR takes the standard strides ((2w−1)² for depth, 2w−1 for height,
MONAI's `WindowAttention`) with `index="swin"`, and a window of N tokens
smaller than the table's uses MONAI's `[:N, :N]` corner of the index.
Every call goes through `ops.attention_cuda.window_attention`, with the
shift labels of a shifted Swin block where it passes them. With a
`tensor_shard` (`parallel/model_parallel.py::shard_model`) the module holds
the q, k and v rows of its rank's heads and a row-parallel `proj`
(`parallel/tensor_sharding.py`), and the kernel runs on those heads; its
input and the bias table enter through `AxisShard.copy`, so their
gradients are the whole line's.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from waveformer_tpu_torch.ops.attention_cuda import window_attention
from waveformer_tpu_torch.parallel.tensor_sharding import row_parallel_linear


# the depth stride of each convention's index, for a window of w
DEPTH_STRIDES = {"waveformer": lambda w: 3 * w - 1,  # reference quirk: not (2w−1)²
                 "swin": lambda w: (2 * w - 1) ** 2}


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: int, convention: str = "waveformer") -> np.ndarray:
    """(N, N) int32 index into the (2w−1)³ bias table, N = window_size³;
    `convention` names the depth stride (`DEPTH_STRIDES`)."""
    ws = window_size
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), np.arange(ws), indexing="ij")
    )
    coords_flatten = coords.reshape(3, -1)
    rel = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel += ws - 1
    rel[:, :, 0] *= DEPTH_STRIDES[convention](ws)
    rel[:, :, 1] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int32)


class WindowAttention(nn.Module):
    """MHSA over flattened windows: (B·nW, N, C) → (B·nW, N, C).

    The bias table stays fp32 whatever the compute dtype, as the JAX
    package keeps its parameters (see `Waveformer.set_compute_dtype`)."""

    tensor_shard = None  # this rank's `tensor` line, set by `shard_model`

    def __init__(
        self,
        dim: int,
        num_heads: int,
        window_size: int,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        index: str = "waveformer",
    ):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.head_dim = dim // num_heads
        self.scale = qk_scale if qk_scale is not None else self.head_dim**-0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 3, num_heads)
        )
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size, index).astype(np.int64)),
        )

    def heads(self) -> Tuple[int, int]:
        """(first, count) of the heads this rank computes: all of them
        without a tensor shard."""
        t = self.tensor_shard
        if t is None:
            return 0, self.num_heads
        h = self.num_heads // t.size
        return t.rank * h, h

    def bias(self, n: Optional[int] = None) -> torch.Tensor:
        """(H, N, N) fp32 bias gathered from the table, for `heads()`; a
        window of `n` < window_size³ tokens takes the index's [:n, :n]."""
        n = self.window_size**3 if n is None else n
        h0, h = self.heads()
        idx = self.relative_position_index[:n, :n].reshape(-1)
        table = self.relative_position_bias_table
        if self.tensor_shard is not None:
            table = self.tensor_shard.copy(table)
        table = table.float()[:, h0:h0 + h]
        return table[idx].reshape(n, n, h).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`labels`: a shifted block's (nW, N) shift regions (see
        `ops.attention_cuda.window_attention`)."""
        b, n, _ = x.shape
        _, h = self.heads()
        if self.tensor_shard is not None:
            x = self.tensor_shard.copy(x)
        qkv = self.qkv(x).reshape(b, n, 3, h, self.head_dim).permute(2, 0, 3, 1, 4)
        out = window_attention(qkv[0], qkv[1], qkv[2], self.bias(n), self.scale, labels)
        out = out.transpose(1, 2).reshape(b, n, h * self.head_dim)
        if self.tensor_shard is None:
            return self.proj(out)
        return row_parallel_linear(out, self.proj, self.tensor_shard)


def cast_keeping_bias_tables(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast `model`'s parameters to `dtype`, keeping every relative-position
    bias table fp32 (its fp32 values, not a rounding of them), as the JAX
    package keeps its parameters."""
    tables = {m: m.relative_position_bias_table.data.float()
              for m in model.modules() if isinstance(m, WindowAttention)}
    model.to(dtype=dtype)
    for m, table in tables.items():
        m.relative_position_bias_table.data = table
