"""Torch WaveFormer `state_dict` → the JAX package's parameter tree.

A copy of `convert_state_dict` and its helpers from
`waveformer_tpu/utils/torch_port.py` (numpy only). It maps the reference's
`state_dict` layout (`network_models/network_backbone.py` module tree, the
port's model included) onto the flax `{"params": ...}` tree:

  * `nn.Linear (out,in)`            → Dense kernel `(in,out)` (transpose)
  * `nn.Conv3d (O,I,kD,kH,kW)`      → channels-last kernel `(kD,kH,kW,I,O)`
  * 1×1×1 convs expressed as Dense  → `(I,O)` squeeze+transpose
  * `PatchEmbed` conv k=s=2         → space-to-depth Dense `(8·I, O)`
  * `ConvTranspose3d (I,O,2,2,2)`   → depth-to-space kernel `(I,2,2,2,O)`

It is the inverse of `utils/jax_params.state_dict_from_jax`: with it a
machine without JAX writes a checkpoint in the JAX package's own format
(`training/checkpoint.save_params_npz`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np


def _strip_module_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove DDP's `module.` prefix (reference `4_predict.py:287-306`)."""
    return {
        (k[len("module.") :] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class _Mapper:
    def __init__(self, sd: Mapping[str, Any]):
        self.sd = {k: _np(v) for k, v in sd.items()}
        self.out: Dict[Tuple[str, ...], np.ndarray] = {}
        self.used: set = set()

    def _get(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def dense(self, tname: str, jpath: Sequence[str], bias: bool = True):
        w = self._get(tname + ".weight")
        self.out[(*jpath, "kernel")] = w.T.copy()
        if bias and self.has(tname + ".bias"):
            self.out[(*jpath, "bias")] = self._get(tname + ".bias")

    def conv(self, tname: str, jpath: Sequence[str], bias: bool = True):
        w = self._get(tname + ".weight")
        self.out[(*jpath, "conv", "kernel")] = w.transpose(2, 3, 4, 1, 0).copy()
        if bias and self.has(tname + ".bias"):
            self.out[(*jpath, "conv", "bias")] = self._get(tname + ".bias")

    def pwconv_dense(self, tname: str, jpath: Sequence[str]):
        w = self._get(tname + ".weight")[:, :, 0, 0, 0]
        self.out[(*jpath, "kernel")] = w.T.copy()
        if self.has(tname + ".bias"):
            self.out[(*jpath, "bias")] = self._get(tname + ".bias")

    def norm(self, tname: str, jpath: Sequence[str]):
        self.out[(*jpath, "scale")] = self._get(tname + ".weight")
        self.out[(*jpath, "bias")] = self._get(tname + ".bias")

    def layernorm(self, tname: str, jpath: Sequence[str]):
        self.norm(tname, jpath)

    def patch_embed(self, tname: str, jpath: Sequence[str]):
        w = self._get(tname + ".weight")  # (O, I, p, p, p)
        o = w.shape[0]
        k = w.transpose(2, 3, 4, 1, 0).reshape(-1, o)
        self.out[(*jpath, "kernel")] = k.copy()
        self.out[(*jpath, "bias")] = self._get(tname + ".bias")

    def conv_transpose2(self, tname: str, jpath: Sequence[str]):
        w = self._get(tname + ".weight")  # (I, O, 2, 2, 2)
        self.out[(*jpath, "kernel")] = w.transpose(0, 2, 3, 4, 1).copy()
        if self.has(tname + ".bias"):
            self.out[(*jpath, "bias")] = self._get(tname + ".bias")

    def raw(self, tname: str, jpath: Sequence[str]):
        self.out[tuple(jpath)] = self._get(tname)


def _map_unet_res_block(m: _Mapper, t: str, j: Sequence[str]):
    m.conv(f"{t}.conv1.conv", (*j, "conv1"), bias=False)
    m.conv(f"{t}.conv2.conv", (*j, "conv2"), bias=False)
    if m.has(f"{t}.conv3.conv.weight"):
        m.conv(f"{t}.conv3.conv", (*j, "conv3"), bias=False)


def convert_state_dict(
    state_dict: Mapping[str, Any],
    depths: Sequence[int] = (2, 2, 2, 2),
    hf_refinement: bool = False,
    strict: bool = True,
) -> Dict[str, Any]:
    """torch `state_dict` → nested flax `{"params": ...}` dict."""
    sd = _strip_module_prefix(state_dict)
    # drop non-parameter buffers
    sd = {k: v for k, v in sd.items() if not k.endswith("relative_position_index")}
    m = _Mapper(sd)
    enc = "waveformer_encoder"

    m.patch_embed(f"{enc}.patch_embed.proj", (enc, "patch_embed", "proj"))

    for s in range(len(depths)):
        for b in range(depths[s]):
            t = f"{enc}.block{s + 1}.{b}"
            j = (enc, f"stage{s + 1}_block{b}")
            m.layernorm(f"{t}.norm1", (*j, "norm1"))
            m.layernorm(f"{t}.norm2", (*j, "norm2"))
            m.dense(f"{t}.attn.qkv", (*j, "attn", "qkv"))
            m.dense(f"{t}.attn.proj", (*j, "attn", "proj"))
            m.raw(
                f"{t}.attn.relative_position_bias_table",
                (*j, "attn", "relative_position_bias_table"),
            )
            m.pwconv_dense(f"{t}.mlp.pwconv", (*j, "mlp", "pwconv"))
            m.conv(f"{t}.mlp.dwconv", (*j, "mlp", "dwconv"))
            m.layernorm(f"{t}.mlp.norm1", (*j, "mlp", "norm1"))
            m.layernorm(f"{t}.mlp.norm2", (*j, "mlp", "norm2"))
            m.dense(f"{t}.mlp.fc", (*j, "mlp", "fc"))
        if s < len(depths) - 1:
            m.layernorm(
                f"{enc}.downsample_{s + 1}.norm",
                (enc, f"downsample_{s + 1}", "norm"),
            )
            m.dense(
                f"{enc}.downsample_{s + 1}.reduction",
                (enc, f"downsample_{s + 1}", "reduction"),
                bias=False,
            )

    for i in (1, 2, 3, 4):
        _map_unet_res_block(m, f"encoder{i}.layer", (f"encoder{i}", "layer"))

    # ChannelCalibration (1×1 convs stay convs in torch; ours are Conv3d too)
    for name in ("reduce", "conv", "expand", "residual"):
        m.conv(f"encoder10.{name}", ("encoder10", name))
    m.dense("encoder10.fc1", ("encoder10", "fc1"))
    m.dense("encoder10.fc2", ("encoder10", "fc2"))

    for d, stage in ((4, 1), (3, 2), (2, 3)):
        t = f"decoder{d}"
        m.conv(f"{t}.conv_lf_block.conv", (t, "conv_lf"), bias=False)
        _map_unet_res_block(m, f"{t}.conv_block", (t, "conv_block"))
        if hf_refinement:
            for i in range(stage):
                m.conv(f"{t}.hf_ref.{i}.conv1", (t, f"hf_ref_{i}", "conv1"))
                m.conv(f"{t}.hf_ref.{i}.conv2", (t, f"hf_ref_{i}", "conv2"))
                m.norm(f"{t}.hf_ref.{i}.norm", (t, f"hf_ref_{i}", "norm"))

    for name, double in (("learnable_up4", True), ("learnable_up3", False)):
        m.conv(f"{name}.conv1.1", (name, "conv1_dw"))
        m.norm(f"{name}.norm", (name, "norm"))
        m.conv(f"{name}.conv2", (name, "conv2"))
        if double:
            m.conv(f"{name}.conv3.0", (name, "conv3_0"))
            m.conv(f"{name}.conv3.2", (name, "conv3_1"))
        else:
            m.conv(f"{name}.conv3", (name, "conv3"))
        m.conv(f"{name}.res_conv.1", (name, "res_conv"))

    m.conv_transpose2(
        "decoder1.transp_conv.conv", ("decoder1", "transp_conv")
    )
    _map_unet_res_block(m, "decoder1.conv_block", ("decoder1", "conv_block"))
    m.conv("out.conv.conv", ("out", "conv"))

    if strict:
        unused = set(m.sd) - m.used
        if unused:
            raise ValueError(f"unconverted torch keys: {sorted(unused)[:10]}")

    # nest the flat dict
    nested: Dict[str, Any] = {}
    for path, arr in m.out.items():
        node = nested
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(arr, dtype=np.float32)
    return {"params": nested}
