"""WaveFormer (arXiv 2503.23764): everything the harness knows of the model.

An architecture's module (`port_bench/archs/<arch>.py`, named by a
configuration file's `"arch"` key, `"waveformer"` where it has none)
gives, for the configuration file's `network` group:

  io(network):            (input channels, output classes, patch size);
  system(network, dtype, device, **kw):
                          the system's model, through the port's public
                          constructor (`kw`: `io_layout`);
  build(network, device): the plain float32 reference, its tensors
                          uninitialised (on "meta" it only traces shapes);
  make_state_dict(network, seed, device):
                          the seeded weights under the reference's keys;
  set_rounding(model, fn): `fn` rounds the reference's product operands
                          (the lower-precision control);
  draw_drop_masks(model, batch, generator, device),
  set_drop_masks(model, masks):
                          a training step's stochastic-depth multipliers,
                          drawn as the system draws them;
  forward_counts(network, batch):
                          (FLOPs, calls) of one forward of `batch` patches:
                          the reference's FLOPs on the "meta" device and
                          the (kernel, shape) of each call that a
                          roofline metric reads.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import model as ref
from port_bench.weights import from_seed

build = ref.build
set_rounding = ref.set_rounding
draw_drop_masks = ref.draw_drop_masks
set_drop_masks = ref.set_drop_masks


def io(network: Dict) -> Tuple[int, int, Tuple[int, ...]]:
    return network["in_chans"], network["out_chans"], tuple(network["img_size"])


def system(network: Dict, dtype: torch.dtype, device, **kw) -> torch.nn.Module:
    from waveformer_tpu_torch.models import create_waveformer

    return create_waveformer(network, dtype=dtype, device=device, **kw)


def _scale(name: str, shape) -> float:
    """The model's own initialisation (the published
    `_init_transformer_weights` and PyTorch's layer defaults): the
    encoder's linear layers 0.02·N(0, 1); every other matrix or kernel N(0,
    1) over sqrt(3·fan-in), the deviation of PyTorch's default uniform; the
    relative-position tables 0.02·N(0, 1). Norms' weights are 1 + 0.1·N(0,
    1) and biases 0.02·N(0, 1) rather than the initial 1 and 0, so that no
    gradient vanishes by construction."""
    if name.endswith("relative_position_bias_table") or name.endswith("bias"):
        return 0.02
    if len(shape) == 1:
        return 0.1
    if len(shape) == 2 and name.startswith("waveformer_encoder."):
        return 0.02
    # PyTorch's fan-in: dimension 1 times the kernel's taps
    return (3 * (torch.Size(shape).numel() // shape[0])) ** -0.5


def make_state_dict(network: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict for `seed`; the relative-position index is the
    reference's."""
    shapes = build(network, "meta").state_dict()
    out = from_seed(shapes, seed, device, _scale)
    for name, t in shapes.items():
        if name.endswith("relative_position_index"):
            ws = round(t.shape[0] ** (1 / 3))
            out[name] = ref.relative_position_index(ws).to(device)
    return {n: out[n] for n in shapes}


def forward_counts(network: Dict, batch: int) -> Tuple[int, List]:
    """FLOPs by `FlopCounterMode`, and the shape of every window-attention
    and depthwise-stencil call."""
    model = build(network, "meta")
    x = torch.empty((batch, *network["img_size"], network["in_chans"]), device="meta")
    calls: List = []
    ref.set_probe(model, calls)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops(), calls
