"""Plain SwinUNETR-V2: the benchmark's frozen reference of the Swin model.

MONAI's `SwinUNETR` (arXiv 2201.01266; `use_v2`: SwinUNETR-V2, arXiv
2303.10180) written out from its equations in plain PyTorch, float32 as the
benchmark runs it (TF32 off: `lowp.plain_precision`). It imports nothing of
the system under test, nor JAX; the UNETR blocks, patch embedding, patch
merging and the two seams are `reference/model.py`'s. The module tree and
its parameter names are MONAI's `state_dict` keys, so one state dict loads
into the reference and into the system.

Layout: channels-last (B, D, H, W, C) inside and at the boundary.

Kept from MONAI on purpose, because trained checkpoints bake them in or
the outputs depend on them: the zero padding to whole windows is attended
and not masked; the shift mask is −100 (not −∞) added to the scores where
the query's and the key's `compute_mask` regions differ; `PatchMerging`
keeps the legacy slice order with its repeated offsets
(`downsample="merging"`); a window smaller than 7³ reads the `[:n, :n]`
corner of the 7³ relative-position index; GELU is exact; every LayerNorm
has eps 1e-5.

Departures from MONAI: no dropout or drop path (the configuration's rates
are 0); odd grids are not padded before patch merging (the configuration's
grids are even); the mask is built from the padded grid of each stage as
MONAI builds it, once a forward.

Seams (`reference/model.py`): `set_rounding(model, fn)` rounds every
operand of a convolution, a linear layer and the attention products;
`set_probe(model, calls)` appends each window-attention call's (windows,
heads, N, D).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.model import (
    Linear,
    PatchEmbed,
    PatchMerging,
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
    _Seams,
    layer_norm_stateless,
    set_probe,
    set_rounding,
)

__all__ = ["SwinUNETR", "build", "set_probe", "set_rounding", "relative_position_index",
           "compute_mask", "draw_drop_masks", "set_drop_masks"]


def relative_position_index(ws: int) -> torch.Tensor:
    """MONAI's (N, N) index into the (2w − 1)³ table: strides (2w − 1)² for
    depth and 2w − 1 for height."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel += ws - 1
    rel[:, :, 0] *= (2 * ws - 1) * (2 * ws - 1)
    rel[:, :, 1] *= 2 * ws - 1
    return torch.from_numpy(rel.sum(-1))


def get_window_size(x_size, window_size, shift_size):
    use_window = list(window_size)
    use_shift = list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


def window_partition(x: torch.Tensor, ws) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws, dims) -> torch.Tensor:
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims, ws, shift, device) -> torch.Tensor:
    """MONAI's (nW, N, N) shift mask over the padded grid `dims`: −100
    between tokens of different regions, 0 within one."""
    d, h, w = dims
    img = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    for sd in slice(-ws[0]), slice(-ws[0], -shift[0]), slice(-shift[0], None):
        for sh in slice(-ws[1]), slice(-ws[1], -shift[1]), slice(-shift[1], None):
            for sw in slice(-ws[2]), slice(-ws[2], -shift[2]), slice(-shift[2], None):
                img[:, sd, sh, sw, :] = cnt
                cnt += 1
    win = window_partition(img, ws).squeeze(-1)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    return mask.masked_fill(mask != 0, float(-100.0)).masked_fill(mask == 0, float(0.0))


class WindowAttention(nn.Module, _Seams):
    def __init__(self, dim: int, num_heads: int, window_size: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 3, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window_size))
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.probe is not None:
            self.probe.append(("window_attention", tuple(q.shape)))
        attn = (self.rnd(q) * self.scale) @ self.rnd(k).transpose(-2, -1)
        idx = self.relative_position_index[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, -1).permute(2, 0, 1)
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, h, n, n) + mask.to(attn.dtype).unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (self.rnd(attn) @ self.rnd(v)).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = Linear(dim, hidden)
        self.linear2 = Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio, qkv_bias):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size[0], qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x, mask):
        shortcut = x
        x = self.norm1(x)
        b, d, h, w, c = x.shape
        ws, shift = get_window_size((d, h, w), self.window_size, self.shift_size)
        pad_d = (ws[0] - d % ws[0]) % ws[0]
        pad_h = (ws[1] - h % ws[1]) % ws[1]
        pad_w = (ws[2] - w % ws[2]) % ws[2]
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
        _, dp, hp, wp, _ = x.shape
        if any(s > 0 for s in shift):
            x = torch.roll(x, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
            attn_mask = mask
        else:
            attn_mask = None
        y = self.attn(window_partition(x, ws), attn_mask)
        x = window_reverse(y.view(-1, *(ws + (c,))), ws, [b, dp, hp, wp])
        if any(s > 0 for s in shift):
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        x = x[:, :d, :h, :w, :]
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, qkv_bias):
        super().__init__()
        self.window_size = (window_size,) * 3
        self.shift_size = tuple(i // 2 for i in self.window_size)
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, self.window_size,
                                 (0, 0, 0) if i % 2 == 0 else self.shift_size, mlp_ratio, qkv_bias)
            for i in range(depth))
        self.downsample = PatchMerging(dim, norm_eps=1e-5)

    def forward(self, x):
        b, d, h, w, c = x.shape
        ws, shift = get_window_size((d, h, w), self.window_size, self.shift_size)
        dims = [int(np.ceil(n / s)) * s for n, s in zip((d, h, w), ws)]
        mask = compute_mask(dims, ws, shift, x.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return self.downsample(x)


class SwinTransformer(nn.Module):
    def __init__(self, in_chans, embed_dim, window_size, depths, num_heads, mlp_ratio,
                 qkv_bias, use_v2):
        super().__init__()
        self.num_layers = len(depths)
        self.use_v2 = use_v2
        self.patch_embed = PatchEmbed(in_chans, embed_dim, 2)
        for i in range(self.num_layers):
            dim = embed_dim * 2 ** i
            setattr(self, f"layers{i + 1}", nn.ModuleList(
                [BasicLayer(dim, depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias)]))
            if use_v2:
                setattr(self, f"layers{i + 1}c", nn.ModuleList([UnetrBasicBlock(dim, dim)]))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.patch_embed(x)
        outs = [layer_norm_stateless(x)]
        for i in range(1, self.num_layers + 1):
            if self.use_v2:
                x = getattr(self, f"layers{i}c")[0](x)
            x = getattr(self, f"layers{i}")[0](x)
            outs.append(layer_norm_stateless(x))
        return outs


class SwinUNETR(nn.Module):
    """(B, D, H, W, C_in) → logits (B, D, H, W, C_out)."""

    def __init__(self, in_channels=4, out_channels=4, feature_size=48, depths=(2, 2, 2, 2),
                 num_heads=(3, 6, 12, 24), window_size=7, use_v2=True, mlp_ratio=4.0,
                 qkv_bias=True):
        super().__init__()
        fs = feature_size
        self.swinViT = SwinTransformer(in_channels, fs, window_size, depths, num_heads,
                                       mlp_ratio, qkv_bias, use_v2)
        self.encoder1 = UnetrBasicBlock(in_channels, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, out_channels)

    def forward(self, x):
        hs = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hs[0])
        enc2 = self.encoder3(hs[1])
        enc3 = self.encoder4(hs[2])
        dec4 = self.encoder10(hs[4])
        dec3 = self.decoder5(dec4, hs[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return self.out(self.decoder1(dec0, enc0))


# the configuration keys of `SwinUNETR`, as the benchmark's configuration files name them
MODEL_KEYS = ("in_channels", "out_channels", "feature_size", "depths", "num_heads",
              "window_size", "use_v2")


def build(network: Dict, device="cpu") -> SwinUNETR:
    """The float32 reference for a configuration file's `network` group on
    `device`, its tensors uninitialised (on "meta" it only traces shapes)."""
    for key, expected in (("drop_path_rate", 0.0), ("patch_size", 2), ("normalize", True),
                          ("downsample", "merging"), ("mlp_ratio", 4.0), ("qkv_bias", True),
                          ("norm_eps", 1e-5)):
        if network.get(key, expected) != expected:
            raise ValueError(f"the reference implements {key}={expected!r} only")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in network.items()
          if k in MODEL_KEYS}
    with torch.device("meta"):
        model = SwinUNETR(**kw)
    return model.to_empty(device=device)


def draw_drop_masks(model, batch, generator, device) -> List[Tuple]:
    """No stochastic depth: the configuration's rate is 0."""
    return []


def set_drop_masks(model, masks: Sequence) -> None:
    """No stochastic depth: nothing to set."""
