"""Plain WaveFormer: the benchmark's frozen reference of the model.

Every operation is a plain PyTorch call in the dtype of the input (float32
as the benchmark runs it, with TF32 off: `lowp.plain_precision`). No kernel of
the system under test, no cache, no batching tricks. The module tree and
its parameter names are the reference `state_dict` keys (the WaveFormer
paper's code, arXiv 2503.23764: `network_models/waveformer.py`,
`wave_helper.py`, `attention.py`, `idwt_upsample.py`, MONAI's UNETR
blocks), so one state dict loads into the reference and into the system.

Layout: channels-last (B, D, H, W, C) inside and at the boundary.

Kept from the published code on purpose, because trained checkpoints bake
them in: the relative-position index's strides (3w - 1 for depth, 2w - 1
for height), the flat row-major merge of attention windows, and the
PatchMerging slice order with its repeated offsets.

Two seams serve the benchmark, both off by default:
  * `set_rounding(model, fn)`: `fn` rounds every operand of a convolution,
    a linear layer and the attention products (the lower-precision control);
  * `set_probe(model, calls)`: each window-attention and depthwise-stencil
    call appends its shape to `calls` (the kernels' byte and FLOP counts).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

DETAIL_KEYS = ("aad", "ada", "add", "daa", "dad", "dda", "ddd")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Seams:
    """Mixin: the rounding applied to product operands and the call probe."""

    rnd = staticmethod(_identity)
    probe: Optional[list] = None


def set_rounding(model: nn.Module, fn=_identity) -> None:
    for m in model.modules():
        if isinstance(m, _Seams):
            m.rnd = fn


def set_probe(model: nn.Module, calls: Optional[list]) -> None:
    for m in model.modules():
        if isinstance(m, _Seams):
            m.probe = calls


def to_cf(x):
    return x.permute(0, 4, 1, 2, 3)


def to_cl(x):
    return x.permute(0, 2, 3, 4, 1)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    var, mean = torch.var_mean(x, dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def layer_norm_stateless(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    var, mean = torch.var_mean(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps)


def resize(x: torch.Tensor, size: Sequence[int], align_corners: bool) -> torch.Tensor:
    """Trilinear resize of channels-last x's three spatial axes."""
    if tuple(x.shape[1:4]) == tuple(size):
        return x
    return to_cl(F.interpolate(to_cf(x), size=tuple(size), mode="trilinear",
                               align_corners=align_corners))


class Linear(nn.Linear, _Seams):
    def forward(self, x):
        b = None if self.bias is None else self.rnd(self.bias)
        return F.linear(self.rnd(x), self.rnd(self.weight), b)


class ConvCL(nn.Conv3d, _Seams):
    """`nn.Conv3d` on channels-last input and output."""

    def forward(self, x):
        c = self.in_channels
        if self.groups == c == self.out_channels and self.kernel_size == (3, 3, 3) \
                and self.probe is not None:
            self.probe.append(("dwconv3", tuple(x.shape)))
        b = None if self.bias is None else self.rnd(self.bias)
        y = F.conv3d(to_cf(self.rnd(x)), self.rnd(self.weight), b, self.stride,
                     self.padding, self.dilation, self.groups)
        return to_cl(y)


class ConvTransposeCL(nn.ConvTranspose3d, _Seams):
    def forward(self, x):
        b = None if self.bias is None else self.rnd(self.bias)
        return to_cl(F.conv_transpose3d(to_cf(self.rnd(x)), self.rnd(self.weight), b,
                                        self.stride))


class Convolution(nn.Module):
    """MONAI `Convolution` shell (`<name>.conv.weight`)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, bias=False, transposed=False):
        super().__init__()
        if transposed:
            self.conv = ConvTransposeCL(cin, cout, kernel_size, stride, bias=bias)
        else:
            self.conv = ConvCL(cin, cout, kernel_size, stride,
                               padding=(kernel_size - stride + 1) // 2, bias=bias)

    def forward(self, x):
        return self.conv(x)


class InstanceNormAffine(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return instance_norm(x, self.eps) * self.weight + self.bias


# --------------------------------------------------------------------------- #
# Haar wavelet (pywt `dwtn` keys: character i is a/d along spatial axis i)
# --------------------------------------------------------------------------- #

_S = 1.0 / math.sqrt(2.0)


def _split(x, axis):
    if x.shape[axis] % 2:
        pad = list(x.shape)
        pad[axis] = 1
        x = torch.cat([x, x.new_zeros(pad)], dim=axis)
    x0 = x.unfold(axis, 2, 2)
    return (x0[..., 0] + x0[..., 1]) * _S, (x0[..., 0] - x0[..., 1]) * _S


def _merge(a, d, axis):
    out = torch.stack([(a + d) * _S, (a - d) * _S], dim=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def dwt3(x) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    bands = {"": x}
    for i in range(3):
        bands = {k + s: t for k, v in bands.items() for s, t in zip("ad", _split(v, 1 + i))}
    return bands["aaa"], {k: bands[k] for k in DETAIL_KEYS}


def idwt3(low, det) -> torch.Tensor:
    bands = {"aaa": low, **det}
    for i in (2, 1, 0):
        bands = {k[:i]: _merge(bands[k[:i] + "a"], bands[k[:i] + "d"], 1 + i)
                 for k in bands if k.endswith("a") and len(k) == i + 1}
    return bands[""]


def waverec3(coeffs) -> torch.Tensor:
    x = coeffs[0]
    for det in coeffs[1:]:
        ref = det["aad"]
        x = x[:, :ref.shape[1], :ref.shape[2], :ref.shape[3]]
        x = idwt3(x, det)
    return x


# --------------------------------------------------------------------------- #
# transformer side
# --------------------------------------------------------------------------- #


def relative_position_index(ws: int) -> torch.Tensor:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel += ws - 1
    rel[:, :, 0] *= 3 * ws - 1
    rel[:, :, 1] *= 2 * ws - 1
    return torch.from_numpy(rel.sum(-1))


class WindowAttention(nn.Module, _Seams):
    def __init__(self, dim, num_heads, window_size, qkv_bias=True, qk_scale=None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.head_dim = dim // num_heads
        self.scale = qk_scale if qk_scale is not None else self.head_dim ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 3, num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window_size))

    def forward(self, x):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.probe is not None:
            self.probe.append(("window_attention", tuple(q.shape)))
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        bias = bias.reshape(n, n, h).permute(2, 0, 1)
        s = torch.matmul(self.rnd(q) * self.scale, self.rnd(k).transpose(-2, -1)) + bias
        p = torch.softmax(s, dim=-1)
        out = torch.matmul(self.rnd(p), self.rnd(v))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class CCF_FFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.pwconv = ConvCL(dim, hidden, 1)
        self.norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.dwconv = ConvCL(hidden, hidden, 3, padding=1, groups=hidden)
        self.norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.fc = Linear(hidden, dim)

    def forward(self, x):
        h = F.gelu(self.norm1(self.pwconv(x)))
        h = F.gelu(self.norm2(self.dwconv(h)))
        return x + self.fc(h)


class WaveFormerBlock(nn.Module):
    """One transformer block. `masks` holds this forward's drop-path
    multipliers, (attention, FFN), each (B,) or None."""

    def __init__(self, dim, num_heads, level, grid, mlp_ratio, qkv_bias, qk_scale,
                 drop_path, norm_eps):
        super().__init__()
        self.level = level
        self.grid = tuple(grid)
        self.window_size = self.grid[0] // (2 ** level)
        self.drop_rate = drop_path
        self.masks: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)
        self.norm1 = nn.LayerNorm(dim, eps=norm_eps)
        self.attn = WindowAttention(dim, num_heads, self.window_size, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim, eps=norm_eps)
        self.mlp = CCF_FFN(dim, int(dim * mlp_ratio))

    def _attend(self, h):
        ws = self.window_size
        b, d, hh, w, c = h.shape
        win = h.reshape(b, d // ws, ws, hh // ws, ws, w // ws, ws, c)
        win = win.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws ** 3, c)
        return self.attn(win).reshape(b, d, hh, w, c)  # the flat merge

    def _drop(self, x, mask):
        if mask is None:
            return x
        return x * mask.reshape(-1, 1, 1, 1, 1) / (1.0 - self.drop_rate)

    def forward(self, x):
        h = self.norm1(x)
        hfs = []
        fused = None
        for _ in range(max(self.level, 1)):
            if self.level > 0:
                h, det = dwt3(h)
                hfs.append(det)
            a = self._attend(h)
            if self.level > 0:
                a = resize(a, self.grid, align_corners=False)
            fused = a if fused is None else fused + a
        x = x + self._drop(fused, self.masks[0])
        x = x + self._drop(self.mlp(self.norm2(x)), self.masks[1])
        return x, tuple(reversed(hfs))


# the PatchMerging slice order of the published code, repeats included
_MERGE = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))


class PatchMerging(nn.Module):
    def __init__(self, dim, norm_eps):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=norm_eps)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        g = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in _MERGE], dim=-1)
        return self.reduction(self.norm(g))


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch):
        super().__init__()
        self.proj = ConvCL(cin, dim, patch, patch)

    def forward(self, x):
        return self.proj(x)


class MultiscaleTransformer(nn.Module):
    def __init__(self, img_size, patch_size, in_chans, embed_dims, num_heads, mlp_ratios,
                 decom_levels, depths, qkv_bias, qk_scale, drop_path_rate, norm_eps):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = PatchEmbed(in_chans, embed_dims[0], patch_size)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        cur = 0
        for s in range(len(depths)):
            grid = tuple(d // (patch_size * 2 ** s) for d in img_size)
            setattr(self, f"block{s + 1}", nn.ModuleList(
                WaveFormerBlock(embed_dims[s], num_heads[s], decom_levels[s], grid,
                                mlp_ratios[s], qkv_bias, qk_scale, dpr[cur + b], norm_eps)
                for b in range(depths[s])))
            cur += depths[s]
            if s < len(depths) - 1:
                setattr(self, f"downsample_{s + 1}", PatchMerging(embed_dims[s], norm_eps))

    def blocks(self) -> List[WaveFormerBlock]:
        return [b for s in range(len(self.depths)) for b in getattr(self, f"block{s + 1}")]

    def forward(self, x):
        h = self.patch_embed(x)
        outs, outs_hf = [], []
        for s in range(len(self.depths)):
            hf = ()
            for blk in getattr(self, f"block{s + 1}"):
                h, hf = blk(h)
            outs.append(layer_norm_stateless(h))
            if s < len(self.depths) - 1:
                outs_hf.append(hf)
                h = getattr(self, f"downsample_{s + 1}")(h)
        return outs, outs_hf


# --------------------------------------------------------------------------- #
# convolutional side
# --------------------------------------------------------------------------- #


class UnetResBlock(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv1 = Convolution(cin, cout, k)
        self.conv2 = Convolution(cout, cout, k)
        self.conv3 = Convolution(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = F.leaky_relu(instance_norm(self.conv1(x)), 0.01)
        h = instance_norm(self.conv2(h))
        r = x if self.conv3 is None else instance_norm(self.conv3(x))
        return F.leaky_relu(h + r, 0.01)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.transp_conv = Convolution(cin, cout, 2, stride=2, transposed=True)
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class UnetOutBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Convolution(cin, cout, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class ChannelCalibration(nn.Module):
    def __init__(self, c, reduction_ratio=4):
        super().__init__()
        rc = c // reduction_ratio
        self.reduce = ConvCL(c, rc, 1)
        self.conv = ConvCL(rc, rc, 3, padding=1)
        self.expand = ConvCL(rc, c, 1)
        self.residual = ConvCL(c, c, 1)
        self.fc1 = Linear(c, rc)
        self.fc2 = Linear(rc, c)

    def forward(self, x):
        identity = self.residual(x)
        h = F.relu(instance_norm(self.reduce(x)))
        h = F.relu(instance_norm(self.conv(h)))
        h = instance_norm(self.expand(h))
        se = torch.sigmoid(self.fc2(F.relu(self.fc1(h.mean(dim=(1, 2, 3))))))
        return F.relu(h * se[:, None, None, None, :] + identity)


class UnetrIDWTBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv_lf_block = Convolution(cin, cout, 3)
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, inp, skip, hf):
        out = waverec3([self.conv_lf_block(inp)] + list(hf))
        return self.conv_block(torch.cat([out, skip], dim=-1))


class _Upsample(nn.Module):
    def __init__(self, stride):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        return resize(x, tuple(s * self.stride for s in x.shape[1:4]), align_corners=True)


class ProjectionUpsample(nn.Module):
    def __init__(self, c, cout, stride, use_double_conv=False):
        super().__init__()
        self.conv1 = nn.Sequential(_Upsample(stride), ConvCL(c, c, 3, padding=1, groups=c))
        self.norm = InstanceNormAffine(c)  # GroupNorm(C, C)
        self.conv2 = ConvCL(c, 2 * c, 1)
        if use_double_conv:
            self.conv3 = nn.Sequential(ConvCL(2 * c, c, 1), nn.GELU(), ConvCL(c, cout, 1))
        else:
            self.conv3 = ConvCL(2 * c, cout, 1)
        self.res_conv = nn.Sequential(_Upsample(stride), ConvCL(c, cout, 1))

    def forward(self, x):
        up = self.conv1[0](x)
        h = self.norm(self.conv1[1](up))
        h = self.conv3(F.gelu(self.conv2(h)))
        return h + self.res_conv[1](up)


class Waveformer(nn.Module):
    """(B, D, H, W, C_in) → logits (B, D, H, W, C_out)."""

    def __init__(self, img_size=(128, 128, 128), patch_size=2, in_chans=4, out_chans=4,
                 embed_dims=(48, 96, 192, 384), depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                 mlp_ratios=(4, 4, 4, 4), decom_levels=(3, 2, 1, 0), qkv_bias=True,
                 qk_scale=None, drop_path_rate=0.1, norm_eps=1e-6):
        super().__init__()
        fs = tuple(embed_dims)
        self.waveformer_encoder = MultiscaleTransformer(
            tuple(img_size), patch_size, in_chans, fs, num_heads, mlp_ratios, decom_levels,
            depths, qkv_bias, qk_scale, drop_path_rate, norm_eps)
        self.encoder1 = UnetrBasicBlock(in_chans, fs[0])
        self.encoder2 = UnetrBasicBlock(fs[0], fs[0])
        self.encoder3 = UnetrBasicBlock(fs[1], fs[1])
        self.encoder4 = UnetrBasicBlock(fs[2], fs[2])
        self.encoder10 = ChannelCalibration(fs[3])
        self.decoder4 = UnetrIDWTBlock(fs[3], fs[2])
        self.decoder3 = UnetrIDWTBlock(fs[3], fs[1])
        self.decoder2 = UnetrIDWTBlock(fs[3], fs[0])
        self.learnable_up4 = ProjectionUpsample(fs[2], fs[0], 4, use_double_conv=True)
        self.learnable_up3 = ProjectionUpsample(fs[1], fs[0], 2)
        self.decoder1 = UnetrUpBlock(3 * fs[0], fs[0])
        self.out = UnetOutBlock(fs[0], out_chans)

    def blocks(self) -> List[WaveFormerBlock]:
        return self.waveformer_encoder.blocks()

    def forward(self, x):
        outs, hf = self.waveformer_encoder(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(outs[0])
        enc2 = self.encoder3(outs[1])
        enc3 = self.encoder4(outs[2])
        dec5 = self.encoder10(outs[3])
        dec4 = self.decoder4(dec5, enc3, hf[-1])
        dec3 = self.decoder3(dec5, enc2, hf[-2])
        dec2 = self.decoder2(dec5, enc1, hf[-3])
        combined = torch.cat([self.learnable_up4(dec4), self.learnable_up3(dec3), dec2], dim=-1)
        return self.out(self.decoder1(combined, enc0))


# the configuration keys of `Waveformer`, as the benchmark's configuration files name them
MODEL_KEYS = ("img_size", "patch_size", "in_chans", "out_chans", "embed_dims", "depths",
              "num_heads", "mlp_ratios", "decom_levels", "qkv_bias", "qk_scale",
              "drop_path_rate", "norm_eps")


def build(network: dict, device="cpu") -> Waveformer:
    """The float32 reference for a configuration file's `network` group on
    `device`, its tensors uninitialised: load a state dict into it (on the
    "meta" device it only traces shapes)."""
    for key, expected in (("multi_scale_attention", True), ("hf_refinement", False),
                          ("res_block", True)):
        if network.get(key, expected) != expected:
            raise ValueError(f"the reference implements {key}={expected} only")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in network.items()
          if k in MODEL_KEYS}
    with torch.device("meta"):
        model = Waveformer(**kw)
    return model.to_empty(device=device)


def drop_rates(model: Waveformer) -> List[float]:
    return [b.drop_rate for b in model.blocks()]


def draw_drop_masks(model: Waveformer, batch: int, generator: torch.Generator,
                    device) -> List[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]:
    """Per block, this step's (attention, FFN) drop-path multipliers (B,),
    drawn from `generator` as timm's DropPath draws them in the forward's
    order: one Bernoulli(keep) draw of shape (B, 1, 1, 1, 1) a site, none
    where the rate is 0."""
    out = []
    for rate in drop_rates(model):
        if rate == 0.0:
            out.append((None, None))
            continue
        pair = tuple(torch.empty((batch, 1, 1, 1, 1), device=device)
                     .bernoulli_(1.0 - rate, generator=generator).reshape(-1)
                     for _ in range(2))
        out.append(pair)
    return out


def set_drop_masks(model: Waveformer, masks) -> None:
    """Give each block its multipliers (None for no drop path)."""
    for blk, m in zip(model.blocks(), masks or [(None, None)] * len(model.blocks())):
        blk.masks = m
