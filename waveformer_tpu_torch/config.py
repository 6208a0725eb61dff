"""Typed configuration in the reference `config.yaml` schema.

A copy of `waveformer_tpu/config.py`: the same dataclasses, fields,
defaults and `from_dict` filtering (unknown top-level keys go to `extra`,
unknown nested keys are dropped). `NetworkConfig` adds, after the JAX
package's fields, the Swin UNETR fields the port alone builds
(`model_type: "SwinUNETR"`). `load_config` reads YAML with the
port's own reader (`utils/yaml_subset.py`), so no PyYAML is needed.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from waveformer_tpu_torch.utils import yaml_subset


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
    """Full model config (reference `utils/network_config.py:15-173`).

    `model_type` picks the model `models.create_model` builds:
    "Waveformer" (the reference's) or "SwinUNETR" (MONAI's `SwinUNETR`,
    SwinUNETR-V2 with `use_v2`), which reads `in_channels`,
    `out_channels`, `img_size`, `feature_size`, `window_size`, `use_v2`
    and the transformer's `depths`, `num_heads` and `drop_path_rate`."""

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
    # Swin UNETR only (MONAI's defaults but `feature_size`, SwinUNETR-V2's 48)
    feature_size: int = 48
    window_size: int = 7
    use_v2: bool = False

    def __post_init__(self):
        if self.spatial_dims != 3:
            raise ValueError("only spatial_dims=3 is supported")
        object.__setattr__(self, "img_size", _as_tuple3(self.img_size))
        if self.model_type == "SwinUNETR" and self.patch_size != 2:
            raise ValueError("SwinUNETR embeds patches of 2 only")
        if self.model_type != "Waveformer":
            return
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
        """Keyword arguments for the model of `model_type`:
        `waveformer_tpu_torch.models.SwinUNETR` for "SwinUNETR", else
        `waveformer_tpu_torch.models.Waveformer`."""
        t = self.transformer
        if self.model_type == "SwinUNETR":
            return dict(
                img_size=self.img_size,
                in_channels=self.in_channels,
                out_channels=self.out_channels,
                feature_size=self.feature_size,
                depths=t.depths,
                num_heads=t.num_heads,
                window_size=self.window_size,
                use_v2=self.use_v2,
                drop_path_rate=t.drop_path_rate,
            )
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
class PredictionConfig:
    """Inference settings (reference `config.yaml:21-29`).

    `tta_orientations` is the first-class serving-protocol knob: the number
    of mirror orientations averaged per case (8 = the reference's full
    `mirror_axes=[0,1,2]` protocol, `4_predict.py:208-211`; 1 = no TTA).
    When set, it overrides `mirror_axes`."""

    best_model_id: str = "best_model.ckpt"
    patch_size: Tuple[int, int, int] = (128, 128, 128)
    sw_batch_size: int = 2
    overlap: float = 0.5
    mirror_axes: Tuple[int, ...] = (0, 1, 2)
    tta_orientations: Optional[int] = None
    raw_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    prediction_save: str = "./prediction_results"
    results_root: str = "prediction_results"

    _TTA_TO_AXES = {1: (), 2: (0,), 4: (0, 1), 8: (0, 1, 2)}

    def __post_init__(self):
        object.__setattr__(self, "patch_size", _as_tuple3(self.patch_size))
        object.__setattr__(self, "mirror_axes", tuple(self.mirror_axes))
        if self.tta_orientations is not None:
            if self.tta_orientations not in self._TTA_TO_AXES:
                raise ValueError(
                    f"tta_orientations must be one of 1/2/4/8, got "
                    f"{self.tta_orientations}"
                )
            object.__setattr__(
                self, "mirror_axes", self._TTA_TO_AXES[self.tta_orientations]
            )

    def effective_mirror_axes(self) -> Optional[Tuple[int, ...]]:
        """The mirror axes to run, or None for no TTA."""
        return self.mirror_axes if self.mirror_axes else None


@dataclass(frozen=True)
class LoggingConfig:
    """Logging settings (reference `config.yaml:32-40`)."""

    enabled: bool = True
    write_to_file: bool = True
    write_to_console: bool = True
    log_file: str = "./logs/training.log"
    log_level_file: str = "debug"
    log_level_console: str = "info"
    rewrite_log: bool = False


@dataclass(frozen=True)
class Config:
    """Top-level config (reference `config.yaml`)."""

    data_dir: str = "./data/fullres/train"
    logdir: str = "./logs/"
    raw_data_dir: str = "./data/raw_data"
    model_name: str = "waveformer_tpu"
    data_list_path: str = "./data_list"
    split_path: str = "default_split"
    max_epoch: int = 1000
    batch_size: int = 4
    val_every: int = 2
    num_steps_per_epoch: int = 250  # reference `light_training/trainer.py:58`
    val_patches_per_epoch: int = 100  # reference `light_training/trainer.py:59`
    full_val_every: int = 0  # epochs between full-volume validations (0=off)
    full_val_cases: int = 2  # whole cases per full-volume validation
    roi_size: Tuple[int, int, int] = (128, 128, 128)
    train_process: int = 12  # data-pipeline worker processes (reference name)
    seed: int = 123
    lr: float = 1e-4
    weight_decay: float = 1e-2
    grad_clip_norm: float = 12.0  # reference `light_training/trainer.py:466`
    scheduler: Optional[str] = None
    warmup_epochs: float = 0.0
    compute_dtype: str = "bfloat16"
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": 1})
    network: NetworkConfig = field(default_factory=NetworkConfig)
    prediction: PredictionConfig = field(default_factory=PredictionConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    extra: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "roi_size", _as_tuple3(self.roi_size))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        d = dict(d)
        net = d.pop("network", {})
        pred = d.pop("prediction", {})
        log = d.pop("logging", {})
        known = {f.name for f in dataclasses.fields(cls)} - {
            "network",
            "prediction",
            "logging",
            "extra",
        }
        extra = {k: v for k, v in d.items() if k not in known}
        d = {k: v for k, v in d.items() if k in known}
        if "roi_size" in d:
            d["roi_size"] = _as_tuple3(d["roi_size"])
        pred_known = {f.name for f in dataclasses.fields(PredictionConfig)}
        pred = {k: v for k, v in pred.items() if k in pred_known}
        if "patch_size" in pred:
            pred["patch_size"] = _as_tuple3(pred["patch_size"])
        if "mirror_axes" in pred:
            pred["mirror_axes"] = tuple(pred["mirror_axes"])
        log_known = {f.name for f in dataclasses.fields(LoggingConfig)}
        log = {k: v for k, v in log.items() if k in log_known}
        return cls(
            network=NetworkConfig.from_dict(net) if net else NetworkConfig(),
            prediction=PredictionConfig(**pred),
            logging=LoggingConfig(**log),
            extra=extra,
            **d,
        )


def load_config(path: str) -> Config:
    """Load a config file in the reference `config.yaml` schema: `.json`
    with `json`, anything else as YAML through the port's own reader
    (`utils/yaml_subset.py`, the subset of YAML configs use; PyYAML is not
    needed)."""
    with open(path, "r") as f:
        text = f.read()
    if str(path).endswith(".json"):
        raw = json.loads(text) if text.strip() else None
    else:
        raw = yaml_subset.safe_load(text)
    return Config.from_dict(raw or {})
