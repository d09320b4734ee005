"""Model registry: ModelConfig -> nn.Module (counterpart:
seld_tpu/models/registry.py). Every grid backbone maps (B, T, C, F)
features to (B, T, M, G) class-major logits; the ACCDOA families map them
to (B, T, M - 1, 3) vectors, or (B, T, 3, M - 1, 3) for multi-ACCDOA
(seld_tpu_torch.accdoa)."""

from __future__ import annotations

import math

import torch
from torch import nn

from seld_tpu_torch import resolve_device
from seld_tpu_torch.config import GridConfig, ModelConfig
from seld_tpu_torch.models.conformer import SELDConformer
from seld_tpu_torch.models.crnn import SELDCRNN
from seld_tpu_torch.models.cspdarknet import SELDCSPDarkNet
from seld_tpu_torch.models.layers import BatchNorm, LayerNorm
from seld_tpu_torch.models.resnet_conformer import SELDResNetConformer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REMAT = ("none", "resnet", "conformer", "all")

ACCDOA_MODELS = {"accdoa_conformer", "multi_accdoa_conformer"}
MULTI_ACCDOA_MODELS = {"multi_accdoa_conformer"}


def _grid_size(grid: GridConfig) -> tuple[int, int]:
    return grid.n_el, grid.n_az


def _crnn(cfg: ModelConfig, grid: GridConfig, in_channels: int, dt: dict) -> nn.Module:
    return SELDCRNN(_grid_size(grid), cfg.num_classes, cfg.crnn_cnn_channels, cfg.crnn_rnn_hidden,
                    cfg.crnn_rnn_layers, in_channels, cfg.n_mels, dropout=cfg.crnn_dropout,
                    **dt)


def _conformer(cfg: ModelConfig, grid: GridConfig, in_channels: int, dt: dict) -> nn.Module:
    return SELDConformer(_grid_size(grid), cfg.num_classes, cfg.crnn_cnn_channels, cfg.conf_d_model,
                         cfg.conf_n_heads, cfg.conf_n_layers, cfg.conf_kernel_size,
                         in_channels, cfg.n_mels, dropout=cfg.conf_dropout, remat=cfg.remat,
                         **dt)


def _resnet_conformer(cfg: ModelConfig, grid: GridConfig, in_channels: int,
                      dt: dict) -> nn.Module:
    return SELDResNetConformer(_grid_size(grid), cfg.num_classes, cfg.resnet_conf_d_model,
                               cfg.resnet_conf_n_heads, cfg.resnet_conf_n_layers,
                               n_channels=in_channels, n_mels=cfg.n_mels,
                               dropout=cfg.resnet_dropout, remat=cfg.remat, **dt)


def _cspdarknet(cfg: ModelConfig, grid: GridConfig, in_channels: int, dt: dict) -> nn.Module:
    return SELDCSPDarkNet(_grid_size(grid), cfg.num_classes, cfg.csp_use_small, in_channels,
                          **dt)


def _accdoa_conformer(cfg: ModelConfig, grid: GridConfig, in_channels: int, dt: dict,
                      tracks: int = 1) -> nn.Module:
    from seld_tpu_torch.accdoa import SELDConformerACCDOA

    return SELDConformerACCDOA(grid.num_classes - 1, tracks, cfg.crnn_cnn_channels,
                               cfg.conf_d_model, cfg.conf_n_heads, cfg.conf_n_layers,
                               cfg.conf_kernel_size, in_channels, cfg.n_mels,
                               dropout=cfg.conf_dropout, remat=cfg.remat, **dt)


MODEL_REGISTRY = {
    "crnn": _crnn,
    "conformer": _conformer,
    "resnet_conformer": _resnet_conformer,
    "cnn": _cspdarknet,  # the reference's name for CSPDarkNet
    "cspdarknet": _cspdarknet,
    # ACCDOA output representation (vectors, not grid logits)
    "accdoa_conformer": _accdoa_conformer,
    # multi-ACCDOA: 3 track slots per class (ADPIT training)
    "multi_accdoa_conformer": lambda cfg, grid, c, dt: _accdoa_conformer(cfg, grid, c, dt, 3),
}


CRNN_F32_BF16_PARAMS_ERROR = (
    "model.model_type=crnn with model.compute_dtype=float32 and "
    "model.param_dtype=bfloat16 is refused: the JAX package's GRU scan carries a "
    "bfloat16 carry in and a float32 one out and raises TypeError at init "
    "(seld_tpu/models/crnn.py:48); use model.compute_dtype=bfloat16 or float32 "
    "parameters")


def _cast_parameters(model: nn.Module, dtype: torch.dtype) -> None:
    """Every parameter of the model in `dtype`; buffers (BatchNorm's running
    statistics) stay float32, as flax keeps batch_stats. setattr keeps
    nn.GRU's flat weight list in step."""
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if p is not None and p.dtype != dtype:
                setattr(module, name, nn.Parameter(p.to(dtype), p.requires_grad))


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: conv, linear and GRU weights from
    N(0, 1/fan_in) (flax's lecun-normal scale), biases 0, norm scales 1,
    BatchNorm running mean 0 and variance 1. Draws on the CPU from
    `generator` in float32; a bf16 parameter takes the draw rounded to
    nearest even."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
            if isinstance(owner, (LayerNorm, BatchNorm)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf.startswith("bias"):  # nn.GRU's are bias_ih_l0, bias_hh_l0, ...
                p.zero_()
            else:
                fan_in = math.prod(p.shape[1:])
                w = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
                p.copy_(w)
        for name, b in model.named_buffers():
            b.fill_(1.0 if name.endswith("running_var") else 0.0)


def build_model(model_cfg: ModelConfig, grid_cfg: GridConfig | None = None,
                device: str | torch.device | None = None,
                seed: int | None = 0, in_channels: int | None = None) -> nn.Module:
    """The eval-mode model of `model_cfg.model_type` on `device` (CUDA
    unless named).

    in_channels: the feature channels C of the (B, T, C, F) input, which
    the stem's width (and its initialisation's fan-in) follows; callers
    pass feature_channels(cfg.features.feature_set, model_cfg.n_channels)
    (7 for "mel_iv", 10 for "mel_gcc"). None means model_cfg.n_channels,
    the "mel" feature set's count.

    seed: initialise the parameters from torch.Generator().manual_seed(seed);
    None leaves them unset for a caller that loads a state_dict next.
    param_dtype "bfloat16" keeps every parameter (weights, biases, norm
    scales and biases, the GRU's weights) in bf16 and BatchNorm's running
    statistics in float32, as flax does; the CRNN with float32 compute and
    bf16 parameters raises ValueError, where the JAX package raises
    TypeError at init. compute_dtype="float32" is true float32: the model's
    forward turns TF32 off for its own duration (seld_tpu_torch.no_tf32). norm_dtype
    "bfloat16" makes every norm return bf16; remat recomputes blocks in
    the backward ("resnet" and "conformer" name the blocks of the models
    that have them; the CRNN and CSPDarkNet have none, as in the JAX
    package)."""
    device = resolve_device(device)
    grid_cfg = grid_cfg or GridConfig(num_classes=model_cfg.num_classes)
    if model_cfg.model_type not in MODEL_REGISTRY:
        raise ValueError(f"unknown model_type {model_cfg.model_type!r}; "
                         f"available: {sorted(MODEL_REGISTRY)}")
    for field in ("compute_dtype", "param_dtype", "norm_dtype"):
        if getattr(model_cfg, field) not in _DTYPES:
            raise ValueError(f"unknown {field} {getattr(model_cfg, field)!r}")
    if (model_cfg.model_type == "crnn" and model_cfg.compute_dtype == "float32"
            and model_cfg.param_dtype == "bfloat16"):
        raise ValueError(CRNN_F32_BF16_PARAMS_ERROR)
    if model_cfg.remat not in REMAT:
        raise ValueError(f"unknown remat {model_cfg.remat!r}; one of {REMAT}")
    dt = dict(compute_dtype=_DTYPES[model_cfg.compute_dtype],
              norm_dtype=_DTYPES[model_cfg.norm_dtype])
    with torch.device("meta"):
        model = MODEL_REGISTRY[model_cfg.model_type](
            model_cfg, grid_cfg, model_cfg.n_channels if in_channels is None else in_channels, dt)
        _cast_parameters(model, _DTYPES[model_cfg.param_dtype])
    model = model.to_empty(device=device).eval()
    model.model_cfg = model_cfg  # the layer list quant.py reads
    if seed is not None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model
