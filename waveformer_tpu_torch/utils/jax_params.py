"""Carry JAX (flax) WaveFormer and SSLViT parameters into the port's `state_dict`.

The inverse of `waveformer_tpu/utils/torch_port.py::convert_state_dict`,
written here with numpy alone (the port imports nothing of the JAX
package). The keys are the reference's, so

    model.load_state_dict(state_dict_from_jax(params), strict=True)

loads weights trained by the JAX package, and `convert_state_dict` of the
result gives the JAX parameters back. The per-module functions take a
parameter subtree and a key prefix; the tests use them module by module.

Layout rules (torch ← flax):
  Linear (out, in)            ← Dense kernel (in, out)
  Conv3d (O, I, kD, kH, kW)   ← conv kernel (kD, kH, kW, I, O)
  1³ conv as Dense            ← kernel (I, O)
  PatchEmbed conv k = s = p   ← space-to-depth Dense (p·p·p·I, O)
  ConvTranspose3d (I, O, 2, 2, 2) ← kernel (I, 2, 2, 2, O)
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from waveformer_tpu_torch.models.attention import relative_position_index

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def dense(sd: StateDict, jp: Mapping, prefix: str, bias: bool = True) -> None:
    sd[_key(prefix, "weight")] = _a(jp["kernel"]).T.copy()
    if bias and "bias" in jp:
        sd[_key(prefix, "bias")] = _a(jp["bias"])


def conv(sd: StateDict, jp: Mapping, prefix: str) -> None:
    """A JAX `Conv3d` (params under `conv`) → a torch Conv3d at `prefix`."""
    core = jp["conv"]
    sd[_key(prefix, "weight")] = _a(core["kernel"]).transpose(4, 3, 0, 1, 2).copy()
    if "bias" in core:
        sd[_key(prefix, "bias")] = _a(core["bias"])


def pwconv_dense(sd: StateDict, jp: Mapping, prefix: str) -> None:
    sd[_key(prefix, "weight")] = _a(jp["kernel"]).T[:, :, None, None, None].copy()
    if "bias" in jp:
        sd[_key(prefix, "bias")] = _a(jp["bias"])


def norm(sd: StateDict, jp: Mapping, prefix: str) -> None:
    sd[_key(prefix, "weight")] = _a(jp["scale"])
    sd[_key(prefix, "bias")] = _a(jp["bias"])


def window_attention(sd: StateDict, jp: Mapping, prefix: str) -> None:
    dense(sd, jp["qkv"], _key(prefix, "qkv"))
    dense(sd, jp["proj"], _key(prefix, "proj"))
    table = _a(jp["relative_position_bias_table"])
    sd[_key(prefix, "relative_position_bias_table")] = table
    ws = int(round(table.shape[0] ** (1.0 / 3.0)) + 1) // 2
    sd[_key(prefix, "relative_position_index")] = relative_position_index(ws).astype(
        np.int64
    )


def ccf_ffn(sd: StateDict, jp: Mapping, prefix: str) -> None:
    pwconv_dense(sd, jp["pwconv"], _key(prefix, "pwconv"))
    conv(sd, jp["dwconv"], _key(prefix, "dwconv"))
    norm(sd, jp["norm1"], _key(prefix, "norm1"))
    norm(sd, jp["norm2"], _key(prefix, "norm2"))
    dense(sd, jp["fc"], _key(prefix, "fc"))


def waveformer_block(sd: StateDict, jp: Mapping, prefix: str) -> None:
    norm(sd, jp["norm1"], _key(prefix, "norm1"))
    norm(sd, jp["norm2"], _key(prefix, "norm2"))
    window_attention(sd, jp["attn"], _key(prefix, "attn"))
    ccf_ffn(sd, jp["mlp"], _key(prefix, "mlp"))


def patch_merging(sd: StateDict, jp: Mapping, prefix: str) -> None:
    norm(sd, jp["norm"], _key(prefix, "norm"))
    dense(sd, jp["reduction"], _key(prefix, "reduction"), bias=False)


def unet_block(sd: StateDict, jp: Mapping, prefix: str) -> None:
    """`UnetResBlock` / `UnetBasicBlock` (MONAI `Convolution` shells)."""
    for name in ("conv1", "conv2", "conv3"):
        if name in jp:
            conv(sd, jp[name], _key(prefix, f"{name}.conv"))


def channel_calibration(sd: StateDict, jp: Mapping, prefix: str) -> None:
    for name in ("reduce", "conv", "expand", "residual"):
        conv(sd, jp[name], _key(prefix, name))
    dense(sd, jp["fc1"], _key(prefix, "fc1"))
    dense(sd, jp["fc2"], _key(prefix, "fc2"))


def idwt_block(sd: StateDict, jp: Mapping, prefix: str, stage: int,
               hf_refinement: bool) -> None:
    conv(sd, jp["conv_lf"], _key(prefix, "conv_lf_block.conv"))
    unet_block(sd, jp["conv_block"], _key(prefix, "conv_block"))
    if hf_refinement:
        for i in range(stage):
            ref = jp[f"hf_ref_{i}"]
            conv(sd, ref["conv1"], _key(prefix, f"hf_ref.{i}.conv1"))
            conv(sd, ref["conv2"], _key(prefix, f"hf_ref.{i}.conv2"))
            norm(sd, ref["norm"], _key(prefix, f"hf_ref.{i}.norm"))


def projection_upsample(sd: StateDict, jp: Mapping, prefix: str) -> None:
    conv(sd, jp["conv1_dw"], _key(prefix, "conv1.1"))
    norm(sd, jp["norm"], _key(prefix, "norm"))
    conv(sd, jp["conv2"], _key(prefix, "conv2"))
    if "conv3_0" in jp:
        conv(sd, jp["conv3_0"], _key(prefix, "conv3.0"))
        conv(sd, jp["conv3_1"], _key(prefix, "conv3.2"))
    else:
        conv(sd, jp["conv3"], _key(prefix, "conv3"))
    if "res_conv" in jp:
        conv(sd, jp["res_conv"], _key(prefix, "res_conv.1"))


def up_block(sd: StateDict, jp: Mapping, prefix: str) -> None:
    kernel = _a(jp["transp_conv"]["kernel"])  # (I, 2, 2, 2, O)
    sd[_key(prefix, "transp_conv.conv.weight")] = kernel.transpose(0, 4, 1, 2, 3).copy()
    unet_block(sd, jp["conv_block"], _key(prefix, "conv_block"))


def state_dict_from_jax(
    params: Mapping[str, Any],
    depths: Sequence[int] = (2, 2, 2, 2),
    hf_refinement: bool = False,
) -> Dict[str, torch.Tensor]:
    """flax `{"params": ...}` (or the bare tree) of a `Waveformer` → the
    port's `state_dict` (CPU fp32 tensors, int64 index buffers)."""
    p = params["params"] if "params" in params else params
    sd: StateDict = {}
    enc, je = "waveformer_encoder", p["waveformer_encoder"]
    pe = _a(je["patch_embed"]["proj"]["kernel"])  # (p·p·p·I, O)
    o = pe.shape[1]
    pconv = _a(p["encoder1"]["layer"]["conv1"]["conv"]["kernel"])
    cin = pconv.shape[3]
    ps = int(round((pe.shape[0] // cin) ** (1.0 / 3.0)))
    sd[f"{enc}.patch_embed.proj.weight"] = (
        pe.reshape(ps, ps, ps, cin, o).transpose(4, 3, 0, 1, 2).copy()
    )
    sd[f"{enc}.patch_embed.proj.bias"] = _a(je["patch_embed"]["proj"]["bias"])
    for s in range(len(depths)):
        for b in range(depths[s]):
            waveformer_block(sd, je[f"stage{s + 1}_block{b}"], f"{enc}.block{s + 1}.{b}")
        if s < len(depths) - 1:
            patch_merging(sd, je[f"downsample_{s + 1}"], f"{enc}.downsample_{s + 1}")
    for i in (1, 2, 3, 4):
        unet_block(sd, p[f"encoder{i}"]["layer"], f"encoder{i}.layer")
    channel_calibration(sd, p["encoder10"], "encoder10")
    for d, stage in ((4, 1), (3, 2), (2, 3)):
        idwt_block(sd, p[f"decoder{d}"], f"decoder{d}", stage, hf_refinement)
    for name in ("learnable_up4", "learnable_up3"):
        projection_upsample(sd, p[name], name)
    up_block(sd, p["decoder1"], "decoder1")
    conv(sd, p["out"]["conv"], "out.conv.conv")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def projection_head_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables `{"params": ..., "batch_stats": ...}` of a JAX
    `ProjectionHead` → the port's `ProjectionHead` state dict (the
    reference's keys; the inverse of `torch_port.convert_projection_head`).
    `num_batches_tracked`, which the flax tree does not hold, is 0."""
    p = variables["params"]
    sd: StateDict = {}
    if "proj" in p:  # linear variant
        conv(sd, p["proj"], "proj")
    else:
        conv(sd, p["proj0"], "proj.0")
        norm(sd, p["bn"], "proj.1.0")
        stats = variables["batch_stats"]["bn"]
        sd["proj.1.0.running_mean"] = _a(stats["mean"])
        sd["proj.1.0.running_var"] = _a(stats["var"])
        conv(sd, p["proj2"], "proj.2")
    out = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if "proj.1.0.running_mean" in out:
        out["proj.1.0.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


# --------------------------------------------------------------------------- #
# SSLViT (`models/ssl.py`): no reference converter exists, so the port's
# names follow the flax tree and the two functions below carry weights both
# ways. Layout rules beyond those above:
#   attention q/k/v Linear (H·Dh, E)  ← DenseGeneral kernel (E, H, Dh), bias (H, Dh)
#   attention out Linear (E, H·Dh)    ← DenseGeneral kernel (H, Dh, E)
#   patch_embed Linear (E, p³·C)      ← space-to-depth Dense kernel (p³·C, E)
# --------------------------------------------------------------------------- #

_QKV = ("query", "key", "value")


def ssl_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax `{"params": ...}` (or the bare tree) of an `SSLViT` → the port's
    `state_dict` (CPU fp32 tensors)."""
    p = params["params"] if "params" in params else params
    sd: StateDict = {}
    v = p["vit"]
    dense(sd, v["patch_embed"], "vit.patch_embed")
    sd["vit.pos_embed"] = _a(v["pos_embed"])
    i = 0
    while f"block{i}" in v:
        jb, pre = v[f"block{i}"], f"vit.block{i}"
        norm(sd, jb["norm1"], f"{pre}.norm1")
        norm(sd, jb["norm2"], f"{pre}.norm2")
        for name in _QKV:
            kernel = _a(jb["attn"][name]["kernel"])
            sd[f"{pre}.attn.{name}.weight"] = kernel.reshape(kernel.shape[0], -1).T.copy()
            sd[f"{pre}.attn.{name}.bias"] = _a(jb["attn"][name]["bias"]).reshape(-1)
        kernel = _a(jb["attn"]["out"]["kernel"])
        sd[f"{pre}.attn.out.weight"] = kernel.reshape(-1, kernel.shape[-1]).T.copy()
        sd[f"{pre}.attn.out.bias"] = _a(jb["attn"]["out"]["bias"])
        dense(sd, jb["mlp_fc1"], f"{pre}.mlp_fc1")
        dense(sd, jb["mlp_fc2"], f"{pre}.mlp_fc2")
        i += 1
    norm(sd, v["norm"], "vit.norm")
    dense(sd, p["proj_contrastive"], "proj_contrastive")
    for name, jp in p.items():
        if name.startswith("dec_conv") or name == "dec_out":
            conv(sd, jp, name)
        elif name.startswith("dec_deconv"):
            sd[f"{name}.weight"] = _a(jp["kernel"]).transpose(0, 4, 1, 2, 3).copy()
            sd[f"{name}.bias"] = _a(jp["bias"])
        elif name == "dec_large":
            dense(sd, jp, name)
    return {k: torch.from_numpy(np.array(a)) for k, a in sd.items()}


def ssl_params_tree(state_dict: Mapping[str, torch.Tensor], num_heads: int) -> Dict:
    """The inverse of `ssl_state_dict_from_jax`: an `SSLViT` state dict (or
    a train state's fp32 masters, by the same names) → the JAX package's
    `{"params": ...}` tree of numpy fp32 arrays."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        w = t.detach().float().cpu().numpy()
        *mods, leaf = key.split(".")
        name = mods[-1]
        if key == "vit.pos_embed":
            path, arrays = ["vit"], {"pos_embed": w}
        elif name in _QKV:
            e = w.shape[-1] if leaf == "weight" else w.shape[0]
            shape = (num_heads, e // num_heads)
            path = mods
            arrays = ({"kernel": w.T.reshape(e, *shape)} if leaf == "weight"
                      else {"bias": w.reshape(shape)})
        elif name == "out" and mods[-2] == "attn":
            path = mods
            arrays = ({"kernel": w.T.reshape(num_heads, -1, w.shape[0])}
                      if leaf == "weight" else {"bias": w})
        elif name.startswith("norm"):
            path, arrays = mods, {"scale" if leaf == "weight" else "bias": w}
        elif name.startswith("dec_conv") or name == "dec_out":
            path = mods + ["conv"]
            arrays = {"kernel": w.transpose(2, 3, 4, 1, 0)} if leaf == "weight" else {"bias": w}
        elif name.startswith("dec_deconv"):
            path = mods
            arrays = {"kernel": w.transpose(0, 2, 3, 4, 1)} if leaf == "weight" else {"bias": w}
        else:  # a Dense
            path, arrays = mods, {"kernel": w.T} if leaf == "weight" else {"bias": w}
        node = tree
        for m in path:
            node = node.setdefault(m, {})
        node.update({k: np.ascontiguousarray(a) for k, a in arrays.items()})
    return {"params": tree}


# --------------------------------------------------------------------------- #
# the legacy 2D modules (`models/legacy2d.py`) and the trainable bilateral
# filter: the names are the flax modules'. Beyond the rules above:
#   Conv2d (O, I/g, kH, kW)  ← conv kernel (kH, kW, I/g, O)
# --------------------------------------------------------------------------- #


def legacy2d_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax `{"params": ...}` (or the bare tree) of a `Mlp2D`, `DWConv2D`,
    `OverlapPatchEmbed2D` or `PosCNN2D` → the port module's `state_dict`:
    each Dense to a Linear, each conv to a Conv2d, the LayerNorm's scale to
    its weight."""
    p = params["params"] if "params" in params else params
    sd: StateDict = {}
    for name, jp in p.items():
        if "scale" in jp:
            norm(sd, jp, name)
        elif np.ndim(jp["kernel"]) == 2:
            dense(sd, jp, name)
        else:
            sd[f"{name}.weight"] = _a(jp["kernel"]).transpose(3, 2, 0, 1).copy()
            sd[f"{name}.bias"] = _a(jp["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def bilateral_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `TrainableBilateralFilter`'s `params` ({"spatial_sigma",
    "color_sigma"}) → the port module's `state_dict` (0-d fp32 tensors)."""
    return {k: torch.tensor(_a(params[k])) for k in ("spatial_sigma", "color_sigma")}
