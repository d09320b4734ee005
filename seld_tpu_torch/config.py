"""Configuration sections the serving path reads.

The port's own copy of FeatureConfig, GridConfig, WindowConfig and
ModelConfig from seld_tpu/config.py, with the same defaults, field names
and dict round-trip, so a config dict stored by either package rebuilds
the same architecture here. Sections and fields the port does not read
(data paths, training, dropout, the other backbones, mesh, the Pallas
toggle) are left out and ignored by `config_from_dict`, exactly as
seld_tpu ignores unknown keys; each comes back with the code that reads
it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any


@dataclass(frozen=True)
class FeatureConfig:
    """Log-mel front-end: torchaudio MelSpectrogram semantics (periodic
    Hann, center/reflect padding, HTK mel scale, norm=None) followed by
    10*log10(max(x, amin))."""

    sample_rate: int = 24_000
    n_fft: int = 960  # 40 ms
    hop_length: int = 480  # 20 ms -> 50 frames per second
    n_mels: int = 64
    f_min: float = 0.0
    f_max: float | None = None  # None means sample_rate / 2
    amin: float = 1e-10
    # "mel" (4 log-mel channels); "mel_iv" / "mel_gcc" need kernel K4,
    # which is not ported yet.
    feature_set: str = "mel"


@dataclass(frozen=True)
class GridConfig:
    """Spatial grid: cell_degrees-wide cells over the sphere."""

    cell_degrees: int = 10
    num_classes: int = 14  # background is the last class

    @property
    def n_el(self) -> int:
        return int(180 // self.cell_degrees)

    @property
    def n_az(self) -> int:
        return int(360 // self.cell_degrees)

    @property
    def n_cells(self) -> int:
        return self.n_el * self.n_az

    @property
    def background_class(self) -> int:
        return self.num_classes - 1


@dataclass(frozen=True)
class WindowConfig:
    """Model windows: 5 s windows (250 frames)."""

    window_seconds: float = 5.0

    def window_frames(self, feat: FeatureConfig) -> int:
        return int(self.window_seconds * feat.sample_rate / feat.hop_length)


@dataclass(frozen=True)
class ModelConfig:
    """Backbone selection and per-model hyperparameters."""

    model_type: str = "resnet_conformer"  # the only family ported so far
    num_classes: int = 14
    n_channels: int = 4
    n_mels: int = 64

    resnet_conf_d_model: int = 512
    resnet_conf_n_heads: int = 8
    resnet_conf_n_layers: int = 4

    # Parameters in float32; convolutions and linears in compute_dtype;
    # norms, the attention softmax and the logits in float32.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    norm_dtype: str = "float32"


@dataclass(frozen=True)
class Config:
    features: FeatureConfig = field(default_factory=FeatureConfig)
    grid: GridConfig = field(default_factory=GridConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    model: ModelConfig = field(default_factory=ModelConfig)


def config_to_dict(cfg: Any) -> dict:
    """Nested config -> plain dicts."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    return cfg


def config_from_dict(d: dict, cls: type = Config) -> Any:
    """Plain dicts -> config; keys this port does not know are ignored."""
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        default = (
            f.default_factory() if f.default_factory is not dataclasses.MISSING
            else None
        )
        if dataclasses.is_dataclass(default):
            kwargs[f.name] = config_from_dict(v, type(default))
        else:
            kwargs[f.name] = v
    return cls(**kwargs)
