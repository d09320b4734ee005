"""Serving checkpoints (counterpart: seld_tpu/train/checkpoint.py).

One file per checkpoint: a torch.save of {"config", "state_dict",
"epoch"}, with the full config dict embedded so that the predictor
rebuilds the exact architecture. Loading uses weights_only=True, so a
checkpoint file can hold tensors and plain data only.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from seld_tpu_torch.config import Config, config_from_dict, config_to_dict


def save_checkpoint(path, model: nn.Module | dict, cfg: Config, epoch: int = 0) -> None:
    """Write `model` (a module or a state_dict) and `cfg` to `path`."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(
        {
            "config": config_to_dict(cfg),
            "state_dict": {k: v.detach().cpu() for k, v in state.items()},
            "epoch": int(epoch),
        },
        path,
    )


def load_checkpoint(path) -> tuple[Config, dict[str, torch.Tensor], int]:
    """-> (config, state_dict on the CPU, epoch)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return config_from_dict(blob["config"]), blob["state_dict"], int(blob["epoch"])
