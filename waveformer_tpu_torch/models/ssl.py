"""Self-supervised pretraining head (contrastive + reconstruction).

Port of `waveformer_tpu/models/ssl.py` (reference `SSLViT`,
`self_supervised/ssl_head.py:9-146`): the 3D ViT encoder, then (a) a Linear
contrastive projection of the mean token, `proj_contrastive`, and (b) a
volumetric reconstruction decoder whose depth follows the ViT patch
(log2(patch) 2× stages):

  * "vae": per stage a 3³ conv, InstanceNorm in fp32, LeakyReLU, the cast
    back and a 2× trilinear resize (`align_corners=False`), then a 1³
    `dec_out`;
  * "deconv": stacked k = s = 2 transposed convs with biases;
  * "large_kernel_deconv": one Linear to p³·C_in and a depth-to-space.

Channels-last throughout, as in the JAX package. The decoder's convs are
cuDNN's (`ConvCL`, `ConvTransposeCL`): the JAX package computes them with
`lax` convolutions, outside any Pallas kernel. Parameter names follow the
flax tree (`vit.*`, `proj_contrastive`, `dec_conv{i}`, `dec_out`,
`dec_deconv{i}`, `dec_large`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from waveformer_tpu_torch.device import resolve_device
from waveformer_tpu_torch.models.common import (ConvCL, ConvTransposeCL, instance_norm,
                                                leaky_relu, to_cf, to_cl)
from waveformer_tpu_torch.models.vit import ViT3D
from waveformer_tpu_torch.ops.resize import resize_trilinear

UPSAMPLE_MODES = ("vae", "deconv", "large_kernel_deconv")


class SSLViT(nn.Module):
    """(B, D, H, W, C) → (embeddings (B, P), reconstruction (B, D, H, W, C))."""

    def __init__(
        self,
        img_size: Tuple[int, int, int] = (96, 96, 96),
        patch_size: int = 16,
        in_channels: int = 1,
        hidden_size: int = 768,
        mlp_dim: int = 3072,
        num_layers: int = 12,
        num_heads: int = 12,
        projection_size: int = 256,
        upsample_mode: str = "vae",
    ):
        super().__init__()
        # as many 2× stages as the patch needs to come back to the input
        # resolution (the reference hard-codes 5, right only at patch 32)
        stages = max(int(np.log2(patch_size)), 1)
        if 2 ** stages != patch_size:
            raise ValueError(f"patch_size {patch_size} must be a power of two for the decoder")
        if upsample_mode not in UPSAMPLE_MODES:
            raise ValueError(f"unknown upsample mode {upsample_mode!r}")
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.upsample_mode = upsample_mode
        self.vit = ViT3D(in_channels, img_size, patch_size, hidden_size, mlp_dim,
                         num_layers, num_heads)
        self.proj_contrastive = nn.Linear(hidden_size, projection_size)
        chs = [max(hidden_size >> (i + 1), 8) for i in range(stages)]
        self.decoder = []
        if upsample_mode == "vae":
            for i, (cin, ch) in enumerate(zip([hidden_size] + chs[:-1], chs)):
                self._add(f"dec_conv{i}", ConvCL(cin, ch, 3, padding=1))
            self.dec_out = ConvCL(chs[-1], in_channels, 1)
        elif upsample_mode == "deconv":
            outs = chs[:-1] + [in_channels]
            for i, (cin, ch) in enumerate(zip([hidden_size] + outs[:-1], outs)):
                self._add(f"dec_deconv{i}", ConvTransposeCL(cin, ch, 2, 2))
        else:
            self.dec_large = nn.Linear(hidden_size, patch_size ** 3 * in_channels)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.decoder.append(module)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.proj_contrastive.weight.dtype

    def set_compute_dtype(self, dtype: torch.dtype) -> "SSLViT":
        """Cast every parameter to `dtype` (the JAX module computes in its
        `dtype` from fp32 parameters; the train state keeps the fp32
        masters)."""
        return self.to(dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.compute_dtype
        x = x.to(dtype)
        b = x.shape[0]
        tokens = self.vit(x)  # (B, N, hidden)
        gd, gh, gw = self.vit.grid
        embeddings = self.proj_contrastive(tokens.mean(dim=1))
        h = tokens.reshape(b, gd, gh, gw, self.hidden_size)
        if self.upsample_mode == "vae":
            for conv in self.decoder:
                # InstanceNorm subtracts each channel's mean, so the conv's
                # bias before it has an exact gradient of 0: it takes part in
                # the forward and gets no gradient (autograd's is rounding),
                # as the attention's key bias (`models/vit.py`)
                h = to_cl(F.conv3d(to_cf(h), conv.weight, conv.bias.detach(), padding=1))
                h = leaky_relu(instance_norm(h)).to(dtype)
                h = resize_trilinear(h, tuple(2 * s for s in h.shape[1:4]), align_corners=False)
            recon = self.dec_out(h)
        elif self.upsample_mode == "deconv":
            for deconv in self.decoder:
                h = deconv(h)
            recon = h
        else:
            p, c = self.patch_size, self.in_channels
            out = self.dec_large(h).reshape(b, gd, gh, gw, p, p, p, c)
            recon = out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, gd * p, gh * p, gw * p, c)
        return embeddings, recon


def create_ssl_vit(
    device: Optional[Union[str, torch.device]] = None,
    seed: Optional[int] = None,
    **kwargs,
) -> SSLViT:
    """An `SSLViT(**kwargs)` in eval mode, in fp32 on `device` (the CUDA
    device unless the caller asks for another); `seed` makes the random
    initial weights reproducible. `master_params(model, dtype)` (as
    `SSLTrainer(compute_dtype=...)` calls it) takes its fp32 weights as the
    masters and casts it."""
    dev = resolve_device(device)
    if seed is not None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = SSLViT(**kwargs)
    else:
        model = SSLViT(**kwargs)
    return model.to(device=dev).eval()
