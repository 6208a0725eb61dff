"""Model and inference configuration defaults.

A copy of the dataclasses of `waveformer_tpu/config.py` that the main path
needs (`TransformerConfig`, `NetworkConfig.model_kwargs`, the roi size).
PyYAML is imported only inside `load_config`, so nothing on the
inference path needs it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _as_tuple3(v) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"expected 3 spatial dims, got {v!r}")
    return t


@dataclass(frozen=True)
class TransformerConfig:
    """Encoder hyperparameters (reference `config.yaml:62-77`)."""

    embed_dims: Tuple[int, ...] = (48, 96, 192, 384)
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4)
    decom_levels: Tuple[int, ...] = (3, 2, 1, 0)
    multi_scale_attention: bool = True
    hf_refinement: bool = False
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    patch_norm: bool = False
    norm_layer: str = "LayerNorm"
    norm_eps: float = 1e-6

    def __post_init__(self):
        n = len(self.embed_dims)
        if not (len(self.depths) == len(self.num_heads) == n):
            raise ValueError(
                "embed_dims, depths, and num_heads must have the same length"
            )
        for d, h in zip(self.embed_dims, self.num_heads):
            if d % h != 0:
                raise ValueError(f"embed dim {d} not divisible by heads {h}")


@dataclass(frozen=True)
class NetworkConfig:
    """Full model config (reference `utils/network_config.py:15-173`)."""

    model_type: str = "Waveformer"
    in_channels: int = 4
    out_channels: int = 4
    img_size: Tuple[int, int, int] = (128, 128, 128)
    patch_size: int = 2
    spatial_dims: int = 3
    res_block: bool = True
    conv_block: bool = True
    use_checkpoint: bool = False
    transformer: TransformerConfig = field(default_factory=TransformerConfig)

    def __post_init__(self):
        if self.spatial_dims != 3:
            raise ValueError("only spatial_dims=3 is supported")
        object.__setattr__(self, "img_size", _as_tuple3(self.img_size))
        for i, lvl in enumerate(self.transformer.decom_levels):
            grid = self.img_size[0] // (self.patch_size * (2**i))
            if grid % (2 ** max(lvl, 0)) != 0:
                raise ValueError(
                    f"stage {i}: grid {grid} not divisible by 2**{lvl}"
                )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NetworkConfig":
        d = dict(d)
        tf = d.pop("transformer", {})
        tf = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in tf.items()
            if k in {f.name for f in dataclasses.fields(TransformerConfig)}
        }
        known = {f.name for f in dataclasses.fields(cls)} - {"transformer"}
        d = {k: v for k, v in d.items() if k in known}
        if "img_size" in d:
            d["img_size"] = _as_tuple3(d["img_size"])
        return cls(transformer=TransformerConfig(**tf), **d)

    def model_kwargs(self) -> Dict[str, Any]:
        """Keyword arguments for `waveformer_tpu_torch.models.Waveformer`."""
        t = self.transformer
        return dict(
            img_size=self.img_size,
            patch_size=self.patch_size,
            in_chans=self.in_channels,
            out_chans=self.out_channels,
            embed_dims=t.embed_dims,
            depths=t.depths,
            num_heads=t.num_heads,
            mlp_ratios=t.mlp_ratios,
            decom_levels=t.decom_levels,
            multi_scale_attention=t.multi_scale_attention,
            hf_refinement=t.hf_refinement,
            qkv_bias=t.qkv_bias,
            qk_scale=t.qk_scale,
            drop_path_rate=t.drop_path_rate,
            norm_eps=t.norm_eps,
            res_block=self.res_block,
            use_checkpoint=self.use_checkpoint,
        )


@dataclass(frozen=True)
class Config:
    """Top-level config: the parts of the reference `config.yaml` that the
    port reads (the patch size and the network)."""

    roi_size: Tuple[int, int, int] = (128, 128, 128)
    network: NetworkConfig = field(default_factory=NetworkConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        net = d.get("network")
        roi = _as_tuple3(d.get("roi_size", cls.roi_size))
        return cls(
            roi_size=roi,
            network=NetworkConfig.from_dict(net) if net else NetworkConfig(),
        )


def load_config(path: str) -> Config:
    """Load a YAML config file in the reference `config.yaml` schema."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}
    return Config.from_dict(raw)
