"""Train state: the step counter, the model and its optimizer as one
object (counterpart: seld_tpu/train/state.py). The model holds the
parameters (in model.param_dtype) and the float32 BatchNorm statistics,
the optimizer the Adam moments (in the parameters' dtype) and the learning
rate; the train step updates all three in place."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    step: int  # optimizer updates taken so far
    model: nn.Module
    optimizer: torch.optim.Optimizer | None  # None for an eval-only state (EMA weights)


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)


def param_count(state: TrainState) -> int:
    return sum(p.numel() for p in state.model.parameters())
