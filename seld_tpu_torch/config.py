"""Configuration sections the serving and training paths read.

The port's own copy of the sections of seld_tpu/config.py, with the same
defaults, field names, dotted `key=value` overrides and dict round-trip,
so a config dict stored by either package rebuilds the same run here.
Fields whose reader is not ported (profiling, the mesh's ZeRO-1 and FSDP
switches, the Pallas toggle) are left out:
`config_from_dict` ignores them, exactly as seld_tpu ignores unknown
keys, and an override of one raises `parse_overrides`'s unknown-field
error. Each comes back with the code that reads it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, replace
from pathlib import Path
from typing import Any


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths, discovery and the single-file debug mode."""

    base_path: str = "."
    audio_dirname: str = "foa_dev"
    metadata_dirname: str = "metadata_dev"
    output_dirname: str = "outputs"
    checkpoint_dirname: str = "checkpoints"

    use_full_dataset: bool = True
    train_audio_file: str = "fold3_room21_mix001.wav"
    train_meta_file: str = "fold3_room21_mix001.csv"
    test_audio_file: str = "fold4_room23_mix001.wav"
    test_meta_file: str = "fold4_room23_mix001.csv"

    prefetch_depth: int = 2  # batches staged and placed ahead of the step
    shuffle_seed: int = 0
    # On-disk corpus cache directory (data/cache.py); "" turns it off.
    cache_dir: str = ""

    @property
    def audio_path(self) -> Path:
        return Path(self.base_path) / self.audio_dirname

    @property
    def metadata_path(self) -> Path:
        return Path(self.base_path) / self.metadata_dirname

    @property
    def output_path(self) -> Path:
        return Path(self.base_path) / self.output_dirname

    @property
    def checkpoint_path(self) -> Path:
        return Path(self.base_path) / self.checkpoint_dirname

    def split_dirs(self, split: str) -> list[tuple[Path, Path]]:
        """(audio_dir, metadata_dir) pairs of a split in {train, test}."""
        if split not in ("train", "test"):
            raise ValueError(f"split must be 'train' or 'test', got {split!r}")
        return [(self.audio_path / f"dev-{split}-{site}",
                 self.metadata_path / f"dev-{split}-{site}")
                for site in ("sony", "tau")]


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
    # "mel" (4 log-mel channels, kernel K1), "mel_iv" (+ 3 FOA intensity
    # vectors) or "mel_gcc" (+ 6 GCC-PHAT pairs), both through kernel K4.
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
    """Corpus windowing: 5 s windows (250 frames) at a 1 s hop over the
    concatenated corpus; the last window is padded with zeros and
    background labels."""

    window_seconds: float = 5.0
    hop_seconds: float = 1.0

    def window_frames(self, feat: FeatureConfig) -> int:
        return int(self.window_seconds * feat.sample_rate / feat.hop_length)

    def hop_frames(self, feat: FeatureConfig) -> int:
        return int(self.hop_seconds * feat.sample_rate / feat.hop_length)


@dataclass(frozen=True)
class TargetConfig:
    """Label rasterization: 100 ms metadata frames fan out to 20 ms label
    frames. The Gaussian spatial augmentation (train side only) paints a
    2-sigma region around each source's direction, displaced once per
    source by a draw keyed on (augmentation_seed, file, class, source).
    accdoa also builds ACCDOA targets beside the bitmask (seld_tpu_torch.accdoa):
    (T, C, 3) vectors with accdoa_tracks = 1, the (T, 6, 4, C) ADPIT layout of
    multi-ACCDOA above it."""

    metadata_frame_ms: int = 100
    label_frame_ms: int = 20
    use_gaussian_augmentation: bool = False
    sigma_azimuth: float = 5.0
    sigma_elevation: float = 5.0
    augmentation_seed: int = 0
    accdoa: bool = False
    accdoa_tracks: int = 1

    @property
    def fanout(self) -> int:
        return self.metadata_frame_ms // self.label_frame_ms  # = 5


@dataclass(frozen=True)
class ModelConfig:
    """Backbone selection and per-model hyperparameters."""

    model_type: str = "resnet_conformer"  # cnn | cspdarknet | crnn | conformer | resnet_conformer
    num_classes: int = 14
    n_channels: int = 4
    n_mels: int = 64

    # CRNN; its CNN encoder is the Conformer's too
    crnn_cnn_channels: tuple[int, ...] = (64, 128, 256, 512)
    crnn_rnn_hidden: int = 256
    crnn_rnn_layers: int = 2
    crnn_dropout: float = 0.3

    # Conformer
    conf_d_model: int = 256
    conf_n_heads: int = 4
    conf_n_layers: int = 2
    conf_kernel_size: int = 31
    conf_dropout: float = 0.3

    # ResNet50-Conformer
    resnet_conf_d_model: int = 512
    resnet_conf_n_heads: int = 8
    resnet_conf_n_layers: int = 4
    resnet_dropout: float = 0.3

    # CSPDarkNet ("cnn"): depth and width multiples (0.33, 0.5) when small
    csp_use_small: bool = True

    # Parameters in float32; convolutions and linears in compute_dtype; the
    # attention softmax and the logits in float32. Norms reduce their
    # statistics and normalise in float32 and return norm_dtype: "bfloat16"
    # halves the bytes every norm writes (no float32 copy of the activation).
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    norm_dtype: str = "float32"
    # Activation checkpointing: recompute instead of saving activations for
    # the backward: "none" | "resnet" (each bottleneck) | "conformer" (each
    # conformer block) | "all"
    remat: str = "none"


@dataclass(frozen=True)
class LossConfig:
    """Composite loss selection: the class term alone, or with the AIUR
    and converging-localization terms."""

    loss_type: str = "mse"  # 'ce' | 'mse'
    w_class: float = 1.0
    w_aiur: float = 1.0
    w_cl: float = 1.0
    use_aiur: bool = False
    use_cl: bool = False
    background_class_weight: float = 0.05  # CE: events weigh 1.0


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule, early stop and checkpoint policy."""

    num_epochs: int = 30
    batch_size: int = 16
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4  # L2 added to the gradient (Adam, not AdamW)
    lr_decay_factor: float = 0.5
    lr_decay_patience: int = 5
    # "plateau": ReduceLROnPlateau on the test loss between epochs;
    # "cosine": per-step warmup + cosine decay over the whole run.
    lr_schedule: str = "plateau"
    warmup_steps: int = 0  # cosine only
    cosine_final_scale: float = 0.01  # cosine floor as a fraction of the LR
    patience: int = 20  # early stopping on the train loss
    min_delta: float = 1e-4
    save_every_n_epochs: int = 5  # rolling checkpoints
    # What picks the best checkpoint: "loss" (the lowest test loss) or a
    # DCASE2022 validation metric computed every epoch from decoded class
    # grids: "seld_error" and "er" (lower is better), "f_macro" (higher).
    # A metric adds one grid read-back per eval batch and a
    # "val_dcase2022" entry per epoch in metrics.jsonl. Early stopping
    # (train loss) and the LR plateau (test loss) do not change.
    select_metric: str = "loss"
    keep_last_n_checkpoints: int = 3
    seed: int = 0
    # Split each batch into N microbatches, add their gradients weighted by
    # each one's share of the example mask, and apply one optimizer update.
    accum_steps: int = 1
    # Quantization-aware training: the int8 PTQ layer set (trunk convs,
    # dense layers, the grid head) fake-quantizes its weights and inputs to
    # the int8 grid with straight-through gradients inside the train step,
    # so the trained weights survive int8 serving (`predict --int8`).
    qat: bool = False
    # Exponential moving average of the parameters (0 = off): the EMA
    # weights are evaluated and stored in the best checkpoint; rolling
    # checkpoints keep the raw weights for an exact resume.
    ema_decay: float = 0.0
    # Knowledge distillation (empty = off): a trained teacher's checkpoint
    # tree. The teacher (architecture from its stored config, best weights:
    # the EMA weights when it trained with ema_decay) runs an eval-mode
    # forward on the student's augmented batches in the train step, and the
    # objective becomes (1 - alpha) * hard_loss + alpha * kd_loss (a
    # T^2-scaled KL over classes for grid heads, a vector MSE for ACCDOA).
    # Teacher and student share features, window, grid and output kind;
    # seld_tpu_torch/distill.py.
    distill_ckpt: str = ""
    distill_alpha: float = 0.5
    distill_temperature: float = 2.0
    # Multi-ACCDOA KD track matching: "permutation" takes the min over the
    # N! orderings of the teacher's tracks per (frame, class), as the hard
    # ADPIT loss does; "position" is the plain slot-wise MSE.
    distill_track_matching: str = "permutation"
    # SpecAugment inside the train step (0 masks = off): per sample, masks
    # of up to `width` frames / mel bins filled with the sample's
    # per-channel mean.
    specaugment_time_masks: int = 0
    specaugment_time_width: int = 25  # frames (0.5 s at 50 fps)
    specaugment_freq_masks: int = 0
    specaugment_freq_width: int = 8  # mel bins
    # FOA spatial augmentation (ACS): per sample one of the 16 label-exact
    # scene transforms, applied to features and labels inside the train
    # step. Needs features.feature_set="mel_iv".
    acs_augment: bool = False
    # torch.profiler trace of steps 1..N of the first epoch (0 = off) as a
    # Chrome-trace JSON under <output>/profile; read it back with
    # `python -m seld_tpu_torch.tools.profile_summary <output>/profile`.
    profile_steps: int = 0
    # Render the loss-component dashboard (viz.visualize_loss_components)
    # of the first test batch every N epochs, 0 = off: an eval-mode forward
    # on the training device into <output>/train_visualizations. Grid
    # models only: an ACCDOA model logs a warning and renders none.
    viz_loss_components_every: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Process mesh (seld_tpu's MeshConfig): one process per GPU, each a
    cell of a (data, model) grid; rank r sits at (r // model_axis,
    r % model_axis).

    enable: "auto" builds the mesh when the process was launched with
    WORLD_SIZE > 1 (torchrun); "on" always builds one (a 1-rank group under
    a plain launch); "off" never does. The data axis splits the batch's
    rows (data parallelism; every rank holds a whole replica of the
    parameters and the gradients are summed over all ranks before Adam).
    shard_time splits the window's time axis over the model axis
    (sequence parallelism: halo exchanges in the convolutions and
    max-pools, ring attention, kernel K5). A model axis without shard_time
    is tensor parallelism, which the port does not have; seld_tpu's
    shard_opt_state (ZeRO-1) and shard_params (FSDP) are left out, so an
    override of either is an unknown-field error."""

    enable: str = "auto"
    data_axis: int = -1  # -1 => every rank the model axis leaves
    model_axis: int = 1
    shard_time: bool = False


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    grid: GridConfig = field(default_factory=GridConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    targets: TargetConfig = field(default_factory=TargetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace_path(self, path: str, value: Any) -> "Config":
        """A new Config with `path` (e.g. 'train.batch_size') replaced."""
        return _replace_nested(self, path, value)


def _replace_nested(obj: Any, path: str, value: Any) -> Any:
    head, _, rest = path.partition(".")
    if head not in {f.name for f in fields(obj)}:
        raise KeyError(f"unknown config field {head!r} on {type(obj).__name__}")
    if rest:
        return replace(obj, **{head: _replace_nested(getattr(obj, head), rest, value)})
    return replace(obj, **{head: _coerce(getattr(obj, head), value)})


def _coerce(current: Any, value: Any) -> Any:
    """A string override as the type of the field's current value."""
    if not isinstance(value, str):
        return value
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        return tuple(int(v) for v in value.strip("()[] ").split(",") if v)
    if current is None:
        try:
            return float(value)
        except ValueError:
            return value
    return value


def parse_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply `a.b.c=value` overrides; an unknown field raises KeyError."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        cfg = cfg.replace_path(key.strip(), val.strip())
    return cfg


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
        elif isinstance(f.default, tuple):  # a JSON round trip gives a list
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)
