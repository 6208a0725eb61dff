"""3D Vision Transformer (the encoder of SSL pretraining).

Port of `waveformer_tpu/models/vit.py` (the MONAI `ViT` of the reference SSL
head, `self_supervised/ssl_head.py:54-66`): a patch embedding written as a
space-to-depth reshape in the order (gd, gh, gw, pd, ph, pw, c) and one
Linear, a learned `pos_embed`, pre-LN transformer blocks with LayerNorm eps
1e-6 (not the 1e-5 of the WaveFormer), no classification token.

The attention is flax's `MultiHeadDotProductAttention`: separate `query`,
`key` and `value` projections with biases, the query scaled by 1/√Dh, an
`out` projection with a bias. The JAX package computes it outside any Pallas
kernel, so the port calls `F.scaled_dot_product_attention`. Parameter names
follow the flax tree (`block{i}.attn.query`, `mlp_fc1`, ...), so
`utils/jax_params.py` carries weights both ways.

The JAX modules' dropout is left out: the SSL script runs it at rate 0,
where it is the identity.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from waveformer_tpu_torch.models.common import gelu


class MultiHeadAttention(nn.Module):
    """flax `MultiHeadDotProductAttention` on (B, N, E), self-attention."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.out = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, e = x.shape
        h = self.num_heads

        def heads(t):
            return t.view(b, n, h, e // h).transpose(1, 2)  # (B, H, N, Dh)

        # the key bias adds q·b to every score of a query's row, which the
        # softmax ignores: its exact gradient is 0, and autograd's is the
        # rounding of a sum that cancels (1e-10..1e-9 in fp32), which AdamW's
        # first step, g / (|g| + eps), turns into up to ±lr on one device and
        # not on another. So the bias takes part in the forward and no
        # gradient flows to it.
        k = F.linear(x, self.key.weight, self.key.bias.detach())
        q, k, v = heads(self.query(x)), heads(k), heads(self.value(x))
        o = F.scaled_dot_product_attention(q, k, v)
        return self.out(o.transpose(1, 2).reshape(b, n, e))


class TransformerBlock(nn.Module):
    """Pre-LN block: x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_size, eps=1e-6)
        self.attn = MultiHeadAttention(hidden_size, num_heads)
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-6)
        self.mlp_fc1 = nn.Linear(hidden_size, mlp_dim)
        self.mlp_fc2 = nn.Linear(mlp_dim, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp_fc2(gelu(self.mlp_fc1(self.norm2(x))))


class ViT3D(nn.Module):
    """(B, D, H, W, C) → token sequence (B, N, hidden), N = the patch grid's
    volume."""

    def __init__(
        self,
        in_channels: int = 1,
        img_size: Tuple[int, int, int] = (96, 96, 96),
        patch_size: int = 16,
        hidden_size: int = 768,
        mlp_dim: int = 3072,
        num_layers: int = 12,
        num_heads: int = 12,
    ):
        super().__init__()
        self.img_size = tuple(img_size)
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        n = 1
        for g in self.grid:
            n *= g
        self.patch_embed = nn.Linear(patch_size ** 3 * in_channels, hidden_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, n, hidden_size))
        self.blocks = []
        for i in range(num_layers):
            block = TransformerBlock(hidden_size, mlp_dim, num_heads)
            self.add_module(f"block{i}", block)
            self.blocks.append(block)
        self.norm = nn.LayerNorm(hidden_size, eps=1e-6)
        # the JAX package's initialisers where it names one (truncated
        # normal, std 0.02); torch's defaults elsewhere
        for w in (self.patch_embed.weight, self.pos_embed,
                  *(m.weight for b in self.blocks for m in (b.mlp_fc1, b.mlp_fc2))):
            nn.init.trunc_normal_(w, std=0.02)
        for m in (self.patch_embed, *(f for b in self.blocks for f in (b.mlp_fc1, b.mlp_fc2))):
            nn.init.zeros_(m.bias)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return tuple(s // self.patch_size for s in self.img_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        p = self.patch_size
        # space-to-depth in the JAX order, then one matmul
        x = x.reshape(b, d // p, p, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
            b, (d // p) * (h // p) * (w // p), p * p * p * c)
        x = self.patch_embed(x) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.norm(x)
