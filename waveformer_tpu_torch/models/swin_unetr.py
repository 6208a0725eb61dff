"""Swin UNETR and SwinUNETR-V2: shifted-window Swin encoder + UNETR decoder.

MONAI's `monai.networks.nets.SwinUNETR` (Hatamizadeh et al., arXiv
2201.01266) and, with `use_v2=True`, SwinUNETR-V2 (He et al., arXiv
2303.10180): a residual conv block (`layers{i}c`) in front of each Swin
stage. The module tree reproduces MONAI's `state_dict` keys
(`swinViT.layers1.0.blocks.0.attn.qkv.weight`, `decoder5.transp_conv.conv.
weight`, ...), so a MONAI checkpoint loads with `strict=True`.

Input and logits follow `io_layout` as in `Waveformer`; inside, the model
is channels-last. Each Swin block is MONAI's: `norm1` → zero-pad each axis
to whole windows (the zeros are attended, not masked) → on odd blocks roll
by −shift → window partition → attention, with the shift regions' labels
on shifted blocks (`ops.attention_cuda.window_attention`) → the true
inverse of the partition → roll back → crop, residual; then `norm2` → MLP
(exact GELU), residual. A stage whose grid is no larger than the window
along an axis takes that size as its window there and does not shift
along it (MONAI's `get_window_size`); its attention then reads the
`[:N, :N]` corner of the 7³ relative-position index. Stages end in the
legacy `PatchMerging` (its repeated slice offsets, MONAI's
`downsample="merging"`), and each stage output goes through the stateless
LayerNorm (`normalize=True`).

Spans (`utils.profiling.span`, recorded only under a profiler):
`swin.encoder` around the Swin encoder's forward and `swin.window_shuffle`
around each block's pad, roll and partition (after `norm1`) and around its
inverse, roll back and crop, each with CUDA events. Counters: `swin_tokens`, the tokens
attended (padding included), and `swin_pad_tokens`, the padding among
them. Model sharding (a mesh's `spatial` or `tensor` line) is not
supported.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.models.attention import WindowAttention, cast_keeping_bias_tables
from waveformer_tpu_torch.models.common import DropPath, PatchEmbed, gelu, layer_norm_stateless
from waveformer_tpu_torch.models.conv_blocks import UnetOutBlock, UnetrBasicBlock, UnetrUpBlock
from waveformer_tpu_torch.models.layers import PatchMerging
from waveformer_tpu_torch.ops.window import (
    cyclic_shift,
    pad_to_windows,
    padded_grid,
    shift_labels,
    window_partition,
    window_unpartition,
)
from waveformer_tpu_torch.utils.profiling import span

# tokens attended by the Swin blocks, and the zero padding among them
swin_tokens = 0
swin_pad_tokens = 0

SHUFFLE_SPAN = "swin.window_shuffle"
ENCODER_SPAN = "swin.encoder"

# MONAI `SwinUNETR` settings this model fixes, at the values it builds
FIXED = {"patch_size": 2, "mlp_ratio": 4.0, "qkv_bias": True, "norm_eps": 1e-5,
         "normalize": True, "downsample": "merging", "spatial_dims": 3}


def stage_window(grid: Sequence[int], window_size: int, shift_size: int
                 ) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """MONAI's `get_window_size`: along an axis no longer than the window,
    the window is the axis and there is no shift."""
    window = tuple(g if g <= window_size else window_size for g in grid)
    shift = tuple(0 if g <= window_size else shift_size for g in grid)
    return window, shift


class SwinMlp(nn.Module):
    """MONAI's `MLPBlock` (`linear1` → exact GELU → `linear2`)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    """One Swin block; `shifted` blocks roll their grid and mask the shift
    regions (MONAI's `SwinTransformerBlock`, LayerNorm eps 1e-5)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shifted: bool,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias=qkv_bias, index="swin")
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, window: Tuple[int, int, int],
                shift: Tuple[int, int, int], labels: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        global swin_tokens, swin_pad_tokens
        d, h, w = x.shape[1:4]
        shift = shift if self.shifted else (0, 0, 0)
        rolled = any(shift)
        y = self.norm1(x)
        with span(SHUFFLE_SPAN, device=True):
            y = pad_to_windows(y, window)
            grid = tuple(y.shape[1:4])
            if rolled:
                y = cyclic_shift(y, [-s for s in shift])
            windows = window_partition(y, window)
        y = self.attn(windows, labels if rolled else None)
        with span(SHUFFLE_SPAN, device=True):
            y = window_unpartition(y, window, grid)
            if rolled:
                y = cyclic_shift(y, shift)
            y = y[:, :d, :h, :w]
        swin_tokens += windows.shape[0] * windows.shape[1]
        swin_pad_tokens += windows.shape[0] * windows.shape[1] - x.shape[0] * d * h * w
        x = x + self.drop_path(y, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class BasicLayer(nn.Module):
    """A Swin stage: blocks with shift 0 and `window_size // 2` in turn,
    then `PatchMerging` (eps 1e-5). The shift labels are computed once a
    forward from the padded grid."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 drop_path: Sequence[float], mlp_ratio: float = 4.0, qkv_bias: bool = True):
        super().__init__()
        self.window_size = window_size
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, window_size, shifted=i % 2 == 1,
                                 mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, drop_path=drop_path[i])
            for i in range(depth))
        self.downsample = PatchMerging(dim, norm_eps=1e-5)
        self._labels: Dict[Tuple, torch.Tensor] = {}

    def labels(self, grid: Tuple[int, int, int], window, shift, device) -> torch.Tensor:
        """The shift labels of the padded `grid` on `device`, kept per
        (grid, window, shift, device)."""
        key = (padded_grid(grid, window), window, shift, device)
        if key not in self._labels:
            self._labels[key] = shift_labels(*key[:3]).to(device)
        return self._labels[key]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        grid = tuple(x.shape[1:4])
        window, shift = stage_window(grid, self.window_size, self.window_size // 2)
        labels = self.labels(grid, window, shift, x.device) if any(shift) else None
        for blk in self.blocks:
            x = blk(x, window, shift, labels, generator)
        return self.downsample(x)


class SwinViT(nn.Module):
    """MONAI's `SwinTransformer`: patch embedding and four stages, each
    after a residual conv block with `use_v2`. Returns the five stateless-
    LayerNorm'd features, patch embedding first."""

    def __init__(self, in_chans: int, embed_dim: int, window_size: int, patch_size: int,
                 depths: Sequence[int], num_heads: Sequence[int], mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0, use_v2: bool = False):
        super().__init__()
        self.num_layers = len(depths)
        self.use_v2 = use_v2
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size)
        dpr = torch.linspace(0, drop_path_rate, sum(depths), device="cpu").tolist()
        for i in range(self.num_layers):
            dim = embed_dim * 2**i
            layer = BasicLayer(dim, depths[i], num_heads[i], window_size,
                               dpr[sum(depths[:i]):sum(depths[:i + 1])], mlp_ratio, qkv_bias)
            setattr(self, f"layers{i + 1}", nn.ModuleList([layer]))
            if use_v2:
                setattr(self, f"layers{i + 1}c", nn.ModuleList([UnetrBasicBlock(dim, dim)]))

    def forward(self, x: torch.Tensor, normalize: bool = True,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        with span(ENCODER_SPAN, device=True):
            h = self.patch_embed(x)
            outs = [layer_norm_stateless(h) if normalize else h]
            for i in range(1, self.num_layers + 1):
                if self.use_v2:
                    h = getattr(self, f"layers{i}c")[0](h)
                h = getattr(self, f"layers{i}")[0](h, generator)
                outs.append(layer_norm_stateless(h) if normalize else h)
        return outs


class SwinUNETR(nn.Module):
    """(B, D, H, W, C_in) → logits (B, D, H, W, out_channels) in the compute
    dtype, or channels-first at both ends with `io_layout="channels_first"`
    (MONAI's `SwinUNETR` with `patch_size=2`, `mlp_ratio=4`, qkv bias,
    instance norm, `normalize=True`, `downsample="merging"`)."""

    # `parallel.model_parallel.check_model_parallel` refuses to shard it
    model_parallel = False

    def __init__(
        self,
        img_size: Tuple[int, int, int] = (128, 128, 128),
        in_channels: int = 4,
        out_channels: int = 4,
        feature_size: int = 48,
        depths: Tuple[int, ...] = (2, 2, 2, 2),
        num_heads: Tuple[int, ...] = (3, 6, 12, 24),
        window_size: int = 7,
        use_v2: bool = True,
        drop_path_rate: float = 0.0,
        io_layout: str = "channels_last",
    ):
        super().__init__()
        if io_layout not in ("channels_last", "channels_first"):
            raise ValueError(f"unknown io_layout {io_layout!r}")
        if feature_size % 12:
            raise ValueError(f"feature_size {feature_size} is not a multiple of 12")
        self.img_size = tuple(img_size)
        self.io_layout = io_layout
        fs = feature_size
        self.swinViT = SwinViT(in_channels, fs, window_size, 2, depths, num_heads,
                               drop_path_rate=drop_path_rate, use_v2=use_v2)
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

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.out.conv.conv.weight.dtype

    def set_compute_dtype(self, dtype: torch.dtype) -> "SwinUNETR":
        """Cast the parameters to `dtype`, the relative-position bias tables
        kept fp32."""
        cast_keeping_bias_tables(self, dtype)
        return self

    def forward(self, x_in: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Logits of `x_in`; in training mode `generator` (on the model's
        device) draws the drop-path masks."""
        x = x_in.to(self.compute_dtype)
        if self.io_layout == "channels_first":
            x = x.permute(0, 2, 3, 4, 1)
        x = x.contiguous()
        hs = self.swinViT(x, generator=generator)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hs[0])
        enc2 = self.encoder3(hs[1])
        enc3 = self.encoder4(hs[2])
        dec4 = self.encoder10(hs[4])
        dec3 = self.decoder5(dec4, hs[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        logits = self.out(self.decoder1(dec0, enc0))
        if self.io_layout == "channels_first":
            return logits.permute(0, 4, 1, 2, 3).contiguous()
        return logits


def create_swin_unetr(
    network_config: Optional[Dict[str, Any]] = None,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
    seed: Optional[int] = None,
    **overrides,
) -> SwinUNETR:
    """Build a `SwinUNETR` from `NetworkConfig.model_kwargs()` and/or
    keyword overrides (`io_layout` included), as `create_waveformer` builds
    its model: eval mode, parameters in `dtype` (bias tables fp32) on
    `device` (the CUDA device unless the caller asks for another); `seed`
    makes the random initial weights reproducible. A key of `FIXED` at
    another value, or a key the model does not take, is refused."""
    dev = resolve_device(device)
    kwargs: Dict[str, Any] = dict(network_config or {})
    kwargs.update(overrides)
    for key, value in FIXED.items():
        if key in kwargs and kwargs.pop(key) != value:
            raise ValueError(f"SwinUNETR builds {key}={value!r} only")
    valid = set(inspect.signature(SwinUNETR).parameters)
    unknown = sorted(set(kwargs) - valid)
    if unknown:
        raise ValueError(f"SwinUNETR takes no {unknown}; it takes {sorted(valid)}")
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}
    if seed is not None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = SwinUNETR(**kwargs)
    else:
        model = SwinUNETR(**kwargs)
    model.to(device=dev)
    model.set_compute_dtype(dtype)
    return model.eval()
