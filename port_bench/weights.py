"""Weights from a seed: a float32 state dict under the reference keys, made
on the device in one generator call.

The scales are the model's own initialisation (the published
`_init_transformer_weights` and PyTorch's layer defaults): the encoder's
linear layers 0.02·N(0, 1); every other matrix or kernel N(0, 1) over
sqrt(3·fan-in), the deviation of PyTorch's default uniform; the
relative-position tables 0.02·N(0, 1). Norms' weights are 1 + 0.1·N(0, 1)
and biases 0.02·N(0, 1) rather than the initial 1 and 0, so that no
gradient vanishes by construction. The relative-position index is the
reference's. The same seed gives the same state dict on the same device.
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench import seeds
from port_bench.reference.model import build, relative_position_index


def _scale(name: str, shape) -> float:
    if name.endswith("relative_position_bias_table") or name.endswith("bias"):
        return 0.02
    if len(shape) == 1:
        return 0.1
    if len(shape) == 2 and name.startswith("waveformer_encoder."):
        return 0.02
    # PyTorch's fan-in: dimension 1 times the kernel's taps
    return (3 * (torch.Size(shape).numel() // shape[0])) ** -0.5


def make_state_dict(network: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of the configuration file's `network` group for `seed`."""
    shapes = build(network, "meta").state_dict()
    floats = [(n, t.shape) for n, t in shapes.items() if t.is_floating_point()]
    total = sum(s.numel() for _, s in floats)
    gen = torch.Generator(device=device)
    gen.manual_seed(seeds.derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in floats:
        v = flat[at:at + shape.numel()].view(shape) * _scale(name, shape)
        if len(shape) == 1 and name.endswith("weight"):
            v = v + 1.0
        out[name] = v
        at += shape.numel()
    for name, t in shapes.items():
        if name.endswith("relative_position_index"):
            ws = round(t.shape[0] ** (1 / 3))
            out[name] = relative_position_index(ws).to(device)
    return {n: out[n] for n in shapes}
