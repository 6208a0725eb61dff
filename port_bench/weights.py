"""Weights from a seed: a float32 state dict made on the device in one
generator call, at scales that the architecture's module gives
(`port_bench/archs/<arch>.py`, `make_state_dict`).

Every floating-point tensor of the state dict, in its order, takes its
stretch of one N(0, 1) draw, times its scale; a one-dimensional `weight`
(a norm's) adds 1. Tensors that are not floating point are the
architecture's to fill. The same seed gives the same state dict on the
same device.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from port_bench import seeds


def from_seed(shapes: Dict[str, torch.Tensor], seed: int, device,
              scale: Callable[[str, torch.Size], float]) -> Dict[str, torch.Tensor]:
    """The floating-point tensors of `shapes` (a state dict, on the "meta"
    device will do) drawn for `seed`, by name."""
    floats = [(n, t.shape) for n, t in shapes.items() if t.is_floating_point()]
    total = sum(s.numel() for _, s in floats)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in floats:
        v = flat[at:at + shape.numel()].view(shape) * scale(name, shape)
        if len(shape) == 1 and name.endswith("weight"):
            v = v + 1.0
        out[name] = v
        at += shape.numel()
    return out
