"""Model registry: ModelConfig -> nn.Module (counterpart:
seld_tpu/models/registry.py). Every backbone maps (B, T, C, F) features
to (B, T, M, G) class-major logits."""

from __future__ import annotations

import math

import torch
from torch import nn

from seld_tpu_torch import resolve_device
from seld_tpu_torch.config import GridConfig, ModelConfig
from seld_tpu_torch.models.layers import BatchNorm, LayerNorm
from seld_tpu_torch.models.resnet_conformer import SELDResNetConformer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Families of the JAX package that this port does not have yet, with the
# ROADMAP item that brings each.
_NOT_PORTED = {
    "crnn": "the other grid backbones",
    "conformer": "the other grid backbones",
    "cnn": "the other grid backbones",
    "cspdarknet": "the other grid backbones",
    "accdoa_conformer": "the ACCDOA families",
    "multi_accdoa_conformer": "the ACCDOA families",
}


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: conv and linear weights from N(0, 1/fan_in)
    (flax's lecun-normal scale), biases 0, norm scales 1, BatchNorm running
    mean 0 and variance 1. Draws on the CPU from `generator`."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
            if isinstance(owner, (LayerNorm, BatchNorm)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
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
    """The eval-mode model on `device` (CUDA unless named).

    in_channels: the feature channels C of the (B, T, C, F) input, which
    the stem's width (and its initialisation's fan-in) follows; callers
    pass feature_channels(cfg.features.feature_set, model_cfg.n_channels)
    (7 for "mel_iv", 10 for "mel_gcc"). None means model_cfg.n_channels,
    the "mel" feature set's count.

    seed: initialise the parameters from torch.Generator().manual_seed(seed);
    None leaves them unset for a caller that loads a state_dict next.
    compute_dtype="float32" is true float32: the model's forward turns
    TF32 off for its own duration (seld_tpu_torch.no_tf32)."""
    device = resolve_device(device)
    grid_cfg = grid_cfg or GridConfig(num_classes=model_cfg.num_classes)
    if model_cfg.model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_cfg.model_type!r} is not ported yet "
            f"(ROADMAP: {_NOT_PORTED[model_cfg.model_type]})"
        )
    if model_cfg.model_type != "resnet_conformer":
        raise ValueError(f"unknown model_type {model_cfg.model_type!r}")
    if model_cfg.param_dtype != "float32" or model_cfg.norm_dtype != "float32":
        raise NotImplementedError(
            "the port keeps parameters and norms in float32 "
            f"(got param_dtype={model_cfg.param_dtype!r}, "
            f"norm_dtype={model_cfg.norm_dtype!r})"
        )
    if model_cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {model_cfg.compute_dtype!r}")
    dtype = _DTYPES[model_cfg.compute_dtype]
    with torch.device("meta"):
        model = SELDResNetConformer(
            grid_size=(grid_cfg.n_el, grid_cfg.n_az),
            num_classes=model_cfg.num_classes,
            d_model=model_cfg.resnet_conf_d_model,
            n_heads=model_cfg.resnet_conf_n_heads,
            n_layers=model_cfg.resnet_conf_n_layers,
            n_channels=model_cfg.n_channels if in_channels is None else in_channels,
            n_mels=model_cfg.n_mels,
            compute_dtype=dtype,
            dropout=model_cfg.resnet_dropout,
        )
    model = model.to_empty(device=device).eval()
    if seed is not None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model
