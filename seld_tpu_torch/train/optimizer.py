"""Optimizer: Adam with coupled L2 weight decay and a host-adjustable
learning rate (counterpart: seld_tpu/train/optimizer.py).

The JAX package chains add_decayed_weights -> scale_by_adam -> scale(-lr):
the decay is L2 added to the gradient of every parameter (biases and norm
scales too) before the Adam moments, and eps is added outside the square
root. That is torch.optim.Adam with weight_decay, not AdamW. The learning
rate stays a Python float in the parameter groups, so the plateau and
cosine schedules rewrite it between steps without touching the device.
"""

from __future__ import annotations

import torch


def make_optimizer(params, learning_rate: float, weight_decay: float = 1e-4,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=float(learning_rate), betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
