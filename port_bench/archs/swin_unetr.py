"""SwinUNETR-V2 (arXiv 2303.10180; MONAI's `SwinUNETR(use_v2=True)`):
everything the harness knows of the model, by the contract in
`archs/waveformer.py`'s docstring.

The configuration file's `network` group uses MONAI's names
(`in_channels`, `out_channels`, `feature_size`, `depths`, `num_heads`,
`window_size`, `use_v2`, ...). The system is the port's
`create_swin_unetr`; a program without it fails when this module loads,
with `UnknownArch`: `port_bench.run` exits 1 before any weights.
"""

from __future__ import annotations

import importlib.util
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import swin_unetr as ref
from port_bench.registry import UnknownArch
from port_bench.weights import from_seed

if importlib.util.find_spec("waveformer_tpu_torch.models.swin_unetr") is None:
    raise UnknownArch("no architecture 'swin_unetr' in this program: "
                      "waveformer_tpu_torch.models.swin_unetr is missing")

build = ref.build
set_rounding = ref.set_rounding
draw_drop_masks = ref.draw_drop_masks
set_drop_masks = ref.set_drop_masks


def io(network: Dict) -> Tuple[int, int, Tuple[int, ...]]:
    return network["in_channels"], network["out_channels"], tuple(network["img_size"])


def system(network: Dict, dtype: torch.dtype, device, **kw) -> torch.nn.Module:
    from waveformer_tpu_torch.models.swin_unetr import create_swin_unetr

    return create_swin_unetr(network, dtype=dtype, device=device, **kw)


def _scale(name: str, shape) -> float:
    """The model's own initialisation: the relative-position tables
    0.02·N(0, 1) (MONAI's trunc-normal 0.02), every linear layer, conv and
    transposed conv N(0, 1) over sqrt(3·fan-in), the deviation of
    PyTorch's default uniform, which MONAI's `SwinUNETR` keeps. Norms'
    weights are 1 + 0.1·N(0, 1) and biases 0.02·N(0, 1) rather than the
    initial 1 and 0, as in `archs/waveformer.py`."""
    if name.endswith("relative_position_bias_table") or name.endswith("bias"):
        return 0.02
    if len(shape) == 1:
        return 0.1
    # PyTorch's fan-in: dimension 1 times the kernel's taps (a transposed
    # conv's dimension 1 is its output, as PyTorch counts it too)
    return (3 * (torch.Size(shape).numel() // shape[0])) ** -0.5


def make_state_dict(network: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict for `seed`; the relative-position indices are the
    reference's (MONAI's strides, the configured window)."""
    shapes = build(network, "meta").state_dict()
    out = from_seed(shapes, seed, device, _scale)
    index = ref.relative_position_index(network["window_size"]).to(device)
    for name in shapes:
        if name.endswith("relative_position_index"):
            out[name] = index
    return {n: out[n] for n in shapes}


def forward_counts(network: Dict, batch: int) -> Tuple[int, List]:
    """FLOPs by `FlopCounterMode`, and the shape of every window-attention
    call, (B·nW, H, N, D)."""
    model = build(network, "meta")
    x = torch.empty((batch, *network["img_size"], network["in_channels"]), device="meta")
    calls: List = []
    ref.set_probe(model, calls)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops(), calls
