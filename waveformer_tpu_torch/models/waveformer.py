"""The WaveFormer model: multiscale DWT-attention encoder + IDWT decoder.

Port of `waveformer_tpu/models/waveformer.py` (reference
`network_models/waveformer.py:36-334`, `network_backbone.py:131-431`).
Input and logits are NCDHW, as the JAX model's
`io_layout="channels_first"`; inside, the model is channels-last like the
JAX package. The module tree reproduces the reference `state_dict` keys,
so released reference checkpoints load with `strict=True`.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.models.attention import WindowAttention
from waveformer_tpu_torch.models.blocks import WaveFormerBlock
from waveformer_tpu_torch.models.common import PatchEmbed, layer_norm_stateless
from waveformer_tpu_torch.models.conv_blocks import (
    ChannelCalibration,
    UnetOutBlock,
    UnetrBasicBlock,
    UnetrUpBlock,
)
from waveformer_tpu_torch.models.decoder import UnetrIDWTBlock
from waveformer_tpu_torch.models.layers import PatchMerging, ProjectionUpsample


class MultiscaleTransformer(nn.Module):
    """4-stage DWT/window-attention encoder on channels-last input.
    Returns `(outs, outs_hf)`: per-stage features (stateless-LN'd, eps
    1e-5, whatever `norm_eps` is) and per-stage HF coefficient tuples."""

    def __init__(
        self,
        img_size: Tuple[int, int, int] = (128, 128, 128),
        patch_size: int = 2,
        in_chans: int = 4,
        embed_dims: Tuple[int, ...] = (48, 96, 192, 384),
        num_heads: Tuple[int, ...] = (3, 6, 12, 24),
        mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4),
        decom_levels: Tuple[int, ...] = (3, 2, 1, 0),
        depths: Tuple[int, ...] = (2, 2, 2, 2),
        multi_scale_attention: bool = True,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        drop_path_rate: float = 0.0,
        norm_eps: float = 1e-6,
        use_checkpoint: bool = False,
    ):
        super().__init__()
        self.depths = tuple(depths)
        self.use_checkpoint = use_checkpoint
        self.patch_embed = PatchEmbed(in_chans, embed_dims[0], patch_size)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths)).tolist()
        cur = 0
        for s in range(len(depths)):
            grid = tuple(d // (patch_size * (2**s)) for d in img_size)
            blocks = nn.ModuleList(
                WaveFormerBlock(
                    embed_dims[s], num_heads[s], decom_levels[s], grid,
                    mlp_ratio=mlp_ratios[s], ms_attention=multi_scale_attention,
                    qkv_bias=qkv_bias, qk_scale=qk_scale,
                    drop_path=dpr[cur + b], norm_eps=norm_eps,
                )
                for b in range(depths[s])
            )
            setattr(self, f"block{s + 1}", blocks)
            cur += depths[s]
            if s < len(depths) - 1:
                setattr(
                    self, f"downsample_{s + 1}",
                    PatchMerging(embed_dims[s], norm_eps=norm_eps),
                )

    def forward(self, x: torch.Tensor, normalize: bool = True):
        h = self.patch_embed(x)
        outs: List[torch.Tensor] = []
        outs_hf: List[Tuple] = []
        n_stages = len(self.depths)
        for s in range(n_stages):
            x_h: Tuple = ()
            for blk in getattr(self, f"block{s + 1}"):
                if self.use_checkpoint and torch.is_grad_enabled():
                    h, x_h = checkpoint(blk, h, use_reentrant=False)
                else:
                    h, x_h = blk(h)
            outs.append(layer_norm_stateless(h) if normalize else h)
            if s < n_stages - 1:
                outs_hf.append(x_h)
                h = getattr(self, f"downsample_{s + 1}")(h)
        return outs, outs_hf


class Waveformer(nn.Module):
    """U-shaped WaveFormer segmentation network: (B, C_in, D, H, W) →
    logits (B, out_chans, D, H, W) in the compute dtype (a list of three
    logits at full, half and quarter resolution with `deep_supervision`)."""

    def __init__(
        self,
        img_size: Tuple[int, int, int] = (128, 128, 128),
        patch_size: int = 2,
        in_chans: int = 4,
        out_chans: int = 4,
        embed_dims: Tuple[int, ...] = (48, 96, 192, 384),
        depths: Tuple[int, ...] = (2, 2, 2, 2),
        num_heads: Tuple[int, ...] = (3, 6, 12, 24),
        mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4),
        decom_levels: Tuple[int, ...] = (3, 2, 1, 0),
        multi_scale_attention: bool = True,
        hf_refinement: bool = False,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        drop_path_rate: float = 0.1,
        norm_eps: float = 1e-6,
        res_block: bool = True,
        use_checkpoint: bool = False,
        deep_supervision: bool = False,
    ):
        super().__init__()
        fs = tuple(embed_dims)
        self.use_checkpoint = use_checkpoint
        self.deep_supervision = deep_supervision
        self.waveformer_encoder = MultiscaleTransformer(
            img_size=img_size, patch_size=patch_size, in_chans=in_chans,
            embed_dims=fs, num_heads=num_heads, mlp_ratios=mlp_ratios,
            decom_levels=decom_levels, depths=depths,
            multi_scale_attention=multi_scale_attention, qkv_bias=qkv_bias,
            qk_scale=qk_scale, drop_path_rate=drop_path_rate,
            norm_eps=norm_eps, use_checkpoint=use_checkpoint,
        )
        self.encoder1 = UnetrBasicBlock(in_chans, fs[0], res_block=res_block)
        self.encoder2 = UnetrBasicBlock(fs[0], fs[0], res_block=res_block)
        self.encoder3 = UnetrBasicBlock(fs[1], fs[1], res_block=res_block)
        self.encoder4 = UnetrBasicBlock(fs[2], fs[2], res_block=res_block)
        self.encoder10 = ChannelCalibration(fs[3], reduction_ratio=4)
        self.decoder4 = UnetrIDWTBlock(
            fs[3], fs[2], 1, hf_refinement=hf_refinement, res_block=res_block
        )
        self.decoder3 = UnetrIDWTBlock(
            fs[3], fs[1], 2, hf_refinement=hf_refinement, res_block=res_block
        )
        self.decoder2 = UnetrIDWTBlock(
            fs[3], fs[0], 3, hf_refinement=hf_refinement, res_block=res_block
        )
        self.learnable_up4 = ProjectionUpsample(
            fs[2], fs[0], stride=4, residual=True, use_double_conv=True
        )
        self.learnable_up3 = ProjectionUpsample(fs[1], fs[0], stride=2, residual=True)
        self.decoder1 = UnetrUpBlock(3 * fs[0], fs[0], res_block=res_block)
        self.out = UnetOutBlock(fs[0], out_chans)
        if deep_supervision:
            self.ds_out1 = UnetOutBlock(fs[0], out_chans)
            self.ds_out2 = UnetOutBlock(fs[1], out_chans)
        self._init_transformer_weights()

    def _init_transformer_weights(self) -> None:
        """Reference `waveformer.py:206-232`: trunc-normal(0.02) linears
        with zero bias, unit LayerNorms."""
        for m in self.waveformer_encoder.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.out.conv.conv.weight.dtype

    def set_compute_dtype(self, dtype: torch.dtype) -> "Waveformer":
        """Cast the parameters to `dtype`, keeping the relative-position
        bias tables fp32 as the JAX package does."""
        self.to(dtype=dtype)
        for m in self.modules():
            if isinstance(m, WindowAttention):
                m.relative_position_bias_table.data = (
                    m.relative_position_bias_table.data.float()
                )
        return self

    def _run(self, mod: nn.Module, *args):
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(mod, *args, use_reentrant=False)
        return mod(*args)

    def forward(self, x_in: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        x = x_in.to(self.compute_dtype).permute(0, 2, 3, 4, 1).contiguous()
        outs, outs_hf = self.waveformer_encoder(x)
        enc0 = self._run(self.encoder1, x)
        enc1 = self._run(self.encoder2, outs[0])
        enc2 = self._run(self.encoder3, outs[1])
        enc3 = self._run(self.encoder4, outs[2])
        dec5 = self.encoder10(outs[3])
        dec4 = self._run(self.decoder4, dec5, enc3, outs_hf[-1])
        dec3 = self._run(self.decoder3, dec5, enc2, outs_hf[-2])
        dec2 = self._run(self.decoder2, dec5, enc1, outs_hf[-3])
        dec4_up = self._run(self.learnable_up4, dec4)
        dec3_up = self._run(self.learnable_up3, dec3)
        combined = torch.cat([dec4_up, dec3_up, dec2], dim=-1)
        dec1 = self._run(self.decoder1, combined, enc0)
        logits = self.out(dec1).permute(0, 4, 1, 2, 3).contiguous()
        if not self.deep_supervision:
            return logits
        aux1 = self.ds_out1(dec2).permute(0, 4, 1, 2, 3).contiguous()
        aux2 = self.ds_out2(dec3).permute(0, 4, 1, 2, 3).contiguous()
        return [logits, aux1, aux2]


def create_waveformer(
    network_config: Optional[Dict[str, Any]] = None,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
    seed: Optional[int] = None,
    **overrides,
) -> Waveformer:
    """Build a `Waveformer` from `NetworkConfig.model_kwargs()` and/or
    keyword overrides, in eval mode, with parameters in `dtype` on
    `device` (the CUDA device unless the caller asks for another).
    `seed` makes the random initial weights reproducible."""
    dev = resolve_device(device)
    kwargs: Dict[str, Any] = {}
    if network_config:
        kwargs.update(network_config)
    kwargs.update(overrides)
    kwargs.pop("io_layout", None)  # always channels-first at the boundary
    valid = set(inspect.signature(Waveformer).parameters)
    kwargs = {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in kwargs.items()
        if k in valid
    }
    if seed is not None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = Waveformer(**kwargs)
    else:
        model = Waveformer(**kwargs)
    model.to(device=dev)
    model.set_compute_dtype(dtype)
    return model.eval()
