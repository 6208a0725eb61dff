"""The WaveFormer model: multiscale DWT-attention encoder + IDWT decoder.

Port of `waveformer_tpu/models/waveformer.py` (reference
`network_models/waveformer.py:36-334`, `network_backbone.py:131-431`).
Input and logits follow `io_layout`, as in the JAX model: (B, D, H, W, C)
for "channels_last" (the default) or (B, C, D, H, W) for
"channels_first"; inside, the model is channels-last like the JAX package. The module tree reproduces the reference `state_dict` keys,
so released reference checkpoints load with `strict=True`.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint as _checkpoint
from torch.utils.checkpoint import set_checkpoint_early_stop

from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.models.attention import cast_keeping_bias_tables
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


def checkpoint(fn, *args):
    """`fn(*args)` under activation checkpointing, recomputed whole in the
    backward: on a model-parallel mesh the recomputation runs the
    forward's collectives again, and every rank of a line must run all of
    them (an early stop after the last saved tensor could differ)."""
    with set_checkpoint_early_stop(False):
        return _checkpoint(fn, *args, use_reentrant=False)


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

    @staticmethod
    def _checkpointed(blk: nn.Module, h: torch.Tensor,
                      generator: Optional[torch.Generator]):
        """`blk(h, generator)` under activation checkpointing. The
        recomputation in the backward restores the generator's state first,
        so it draws the forward's drop-path masks again."""
        if generator is None:
            return checkpoint(blk, h)
        state = generator.get_state()

        def run(x):
            generator.set_state(state)
            return blk(x, generator)

        return checkpoint(run, h)

    def forward(self, x: torch.Tensor, normalize: bool = True,
                generator: Optional[torch.Generator] = None):
        h = self.patch_embed(x)
        outs: List[torch.Tensor] = []
        outs_hf: List[Tuple] = []
        n_stages = len(self.depths)
        for s in range(n_stages):
            x_h: Tuple = ()
            for blk in getattr(self, f"block{s + 1}"):
                if self.use_checkpoint and torch.is_grad_enabled():
                    h, x_h = self._checkpointed(blk, h, generator)
                else:
                    h, x_h = blk(h, generator)
            outs.append(layer_norm_stateless(h) if normalize else h)
            if s < n_stages - 1:
                outs_hf.append(x_h)
                h = getattr(self, f"downsample_{s + 1}")(h)
        return outs, outs_hf


class Waveformer(nn.Module):
    """U-shaped WaveFormer segmentation network: (B, D, H, W, C_in) →
    logits (B, D, H, W, out_chans) in the compute dtype, or (B, C_in, D, H,
    W) → (B, out_chans, D, H, W) with `io_layout="channels_first"` (a list
    of three logits at full, half and quarter resolution with
    `deep_supervision`). The layout does not change the parameters."""

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
        io_layout: str = "channels_last",
    ):
        super().__init__()
        if io_layout not in ("channels_last", "channels_first"):
            raise ValueError(f"unknown io_layout {io_layout!r}")
        self.io_layout = io_layout
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
        bias tables fp32 (their fp32 values, not a bf16 rounding of them) as
        the JAX package does."""
        cast_keeping_bias_tables(self, dtype)
        return self

    def _run(self, mod: nn.Module, *args):
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(mod, *args)
        return mod(*args)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.io_layout == "channels_first":
            return h.permute(0, 4, 1, 2, 3).contiguous()
        return h

    def forward(self, x_in: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Logits of `x_in`; in training mode `generator` (on the model's
        device) draws the drop-path masks."""
        x = x_in.to(self.compute_dtype)
        if self.io_layout == "channels_first":
            x = x.permute(0, 2, 3, 4, 1)
        x = x.contiguous()
        outs, outs_hf = self.waveformer_encoder(x, generator=generator)
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
        logits = self._logits(self.out(dec1))
        if not self.deep_supervision:
            return logits
        return [logits, self._logits(self.ds_out1(dec2)), self._logits(self.ds_out2(dec3))]


def create_waveformer(
    network_config: Optional[Dict[str, Any]] = None,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
    seed: Optional[int] = None,
    **overrides,
) -> Waveformer:
    """Build a `Waveformer` from `NetworkConfig.model_kwargs()` and/or
    keyword overrides (`io_layout` included, "channels_last" by default as
    in the JAX package), in eval mode, with parameters in `dtype` on
    `device` (the CUDA device unless the caller asks for another).
    `seed` makes the random initial weights reproducible."""
    dev = resolve_device(device)
    kwargs: Dict[str, Any] = {}
    if network_config:
        kwargs.update(network_config)
    kwargs.update(overrides)
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
