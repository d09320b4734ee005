"""Host-side schedules: plateau LR decay, early stopping, warmup + cosine
(counterpart: seld_tpu/train/schedule.py). All three are plain Python
between epochs or steps; none touches the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min',
    threshold=1e-4 relative, cooldown=0, min_lr=0) with factor 0.5 and
    patience 5 by default."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = field(default=float("inf"))
    num_bad_epochs: int = 0

    def step(self, metric: float) -> float:
        """Record an epoch metric; returns the (possibly reduced) LR."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr


@dataclass
class EarlyStopping:
    """Early stop on the train loss: improvement means
    loss < best - min_delta (absolute); stop after `patience` epochs
    without improvement."""

    patience: int = 20
    min_delta: float = 1e-4
    best: float = field(default=float("inf"))
    best_epoch: int = 0
    epochs_without_improvement: int = 0

    def step(self, loss: float, epoch: int) -> bool:
        """Record an epoch loss; returns True when training should stop."""
        if loss < self.best - self.min_delta:
            self.best = loss
            self.best_epoch = epoch
            self.epochs_without_improvement = 0
        else:
            self.epochs_without_improvement += 1
        return self.epochs_without_improvement >= self.patience


@dataclass
class WarmupCosine:
    """Per-step warmup + cosine decay, computed on the host and written
    into the optimizer's LR before each step.

    lr(step) = peak * (step + 1) / warmup_steps           (warmup)
             = final + (peak - final)/2 * (1 + cos(pi*p)) (decay)
    with p = (step - warmup) / max(total - warmup, 1) and
    final = peak * final_scale.
    """

    peak: float
    total_steps: int
    warmup_steps: int = 0
    final_scale: float = 0.01

    def __call__(self, step: int) -> float:
        if self.warmup_steps > 0 and step < self.warmup_steps:
            return self.peak * (step + 1) / self.warmup_steps
        final = self.peak * self.final_scale
        horizon = max(self.total_steps - self.warmup_steps, 1)
        p = min(max(step - self.warmup_steps, 0) / horizon, 1.0)
        return final + (self.peak - final) * 0.5 * (1.0 + math.cos(math.pi * p))
