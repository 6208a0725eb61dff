"""A second architecture for the harness's tests only: a two-conv U-net
(3³ conv, InstanceNorm, a 2³ stride-2 conv down, trilinear up, 3³ conv on
the skip and the upsampled path, 1³ head). The system is built from the
port's channels-last layers; the reference below is plain float32 PyTorch.
`toy.add_toy` copies this file into a checkout as `port_bench/archs/toy.py`,
as a later change adds an architecture."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from port_bench.weights import from_seed


def io(network: Dict) -> Tuple[int, int, Tuple[int, ...]]:
    return network["in_chans"], network["out_chans"], tuple(network["img_size"])


def _up(x_cl: torch.Tensor) -> torch.Tensor:
    y = F.interpolate(x_cl.permute(0, 4, 1, 2, 3), scale_factor=2, mode="trilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 4, 1)


class System(nn.Module):
    """(B, D, H, W, C) → (B, D, H, W, K) in the compute dtype, or
    channels-first at both ends with `io_layout="channels_first"`."""

    def __init__(self, network: Dict, io_layout: str = "channels_last"):
        from waveformer_tpu_torch.models.common import ConvCL, InstanceNormAffine

        super().__init__()
        c, k, _ = io(network)
        w = network["width"]
        self.io_layout = io_layout
        self.enc = ConvCL(c, w, 3, padding=1)
        self.norm = InstanceNormAffine(w)
        self.down = ConvCL(w, 2 * w, 2, stride=2)
        self.dec = ConvCL(3 * w, w, 3, padding=1)
        self.out = ConvCL(w, k, 1)

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        for m in (self.enc, self.down, self.dec, self.out):
            m.to(dtype)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        cf = self.io_layout == "channels_first"
        x = (x.permute(0, 2, 3, 4, 1) if cf else x).to(self.enc.weight.dtype)
        e = F.gelu(self.norm(self.enc(x)))
        d = F.gelu(self.down(e))
        y = self.out(F.gelu(self.dec(torch.cat([e, _up(d)], dim=-1))))
        return y.permute(0, 4, 1, 2, 3) if cf else y


class Reference(nn.Module):
    """The plain float32 toy: channels-last in and out, every product
    operand through `rnd` (the lower-precision control)."""

    def __init__(self, network: Dict):
        super().__init__()
        c, k, _ = io(network)
        w = network["width"]
        self.enc = nn.Conv3d(c, w, 3, padding=1)
        self.norm = nn.Module()
        self.norm.weight = nn.Parameter(torch.ones(w))
        self.norm.bias = nn.Parameter(torch.zeros(w))
        self.down = nn.Conv3d(w, 2 * w, 2, stride=2)
        self.dec = nn.Conv3d(3 * w, w, 3, padding=1)
        self.out = nn.Conv3d(w, k, 1)
        self.rnd = lambda t: t

    def _conv(self, m: nn.Conv3d, x_cf: torch.Tensor) -> torch.Tensor:
        return F.conv3d(self.rnd(x_cf), self.rnd(m.weight), self.rnd(m.bias), m.stride,
                        m.padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        h = self._conv(self.enc, x)
        var, mean = torch.var_mean(h, dim=(2, 3, 4), keepdim=True, unbiased=False)
        h = (h - mean) / torch.sqrt(var + 1e-5)
        e = F.gelu(h * self.norm.weight.view(1, -1, 1, 1, 1) + self.norm.bias.view(1, -1, 1, 1, 1))
        d = F.gelu(self._conv(self.down, e))
        u = F.interpolate(d, scale_factor=2, mode="trilinear", align_corners=False)
        y = self._conv(self.out, F.gelu(self._conv(self.dec, torch.cat([e, u], dim=1))))
        return y.permute(0, 2, 3, 4, 1)


def system(network: Dict, dtype: torch.dtype, device, **kw) -> nn.Module:
    model = System(network, **kw).to(device)
    model.set_compute_dtype(dtype)
    return model


def build(network: Dict, device="cpu") -> Reference:
    with torch.device("meta"):
        model = Reference(network)
    return model.to_empty(device=device)


def set_rounding(model: Reference, fn) -> None:
    model.rnd = fn


def draw_drop_masks(model, batch: int, generator, device) -> List:
    return []  # no stochastic depth


def set_drop_masks(model, masks) -> None:
    pass


def _scale(name: str, shape) -> float:
    if name.endswith("bias"):
        return 0.02
    if len(shape) == 1:
        return 0.1
    return (3 * (torch.Size(shape).numel() // shape[0])) ** -0.5


def make_state_dict(network: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return from_seed(build(network, "meta").state_dict(), seed, device, _scale)


def forward_counts(network: Dict, batch: int) -> Tuple[int, List]:
    c, _, size = io(network)
    x = torch.empty((batch, *size, c), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        build(network, "meta")(x)
    return counter.get_total_flops(), []  # no kernel that a roofline reads
