"""Optimizer: Adam with coupled L2 weight decay and a host-adjustable
learning rate (counterpart: seld_tpu/train/optimizer.py).

The JAX package chains add_decayed_weights -> scale_by_adam -> scale(-lr):
the decay is L2 added to the gradient of every parameter (biases and norm
scales too) before the Adam moments, and eps is added outside the square
root. That is torch.optim.Adam with weight_decay, not AdamW. The learning
rate stays a Python float in the parameter groups, so the plateau and
cosine schedules rewrite it between steps without touching the device.

float32 parameters take torch.optim.Adam. bf16 parameters take `ChainAdam`,
which keeps the moments in bf16 and computes optax's chain in optax's order
and with its roundings: torch.optim.Adam reaches the same update by other
operations (lerp, sqrt(nu) / sqrt(bias correction), addcdiv), which in bf16
round differently.
"""

from __future__ import annotations

import numpy as np
import torch


def rounded(x: float, dtype: torch.dtype) -> float:
    """A Python scalar as JAX uses a weak-typed one against `dtype`
    tensors: rounded to `dtype` first."""
    return torch.tensor(x, dtype=dtype).item()


class ChainAdam(torch.optim.Optimizer):
    """optax.chain(add_decayed_weights(wd), scale_by_adam(b1, b2, eps),
    scale(-lr)) followed by p + u.astype(p.dtype), one rounding to the
    parameter's dtype after every operation, as XLA computes it:

        g  = g + wd * p
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g * g + b2 * nu
        u  = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
        p  = p + (-lr) * u

    Every scalar is rounded to the parameter's dtype (a weak-typed constant
    in JAX, and the learning rate, which optax.inject_hyperparams holds in
    the parameters' dtype); the bias corrections are computed in float32
    and then rounded. The moments are "mu" and "nu" in the state, with the
    update count "step" (optax's `count`)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=float(lr), betas=tuple(betas), eps=float(eps),
                                      weight_decay=float(weight_decay)))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            by_kind: dict = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["step"] += 1
                by_kind.setdefault((p.device, p.dtype, state["step"]), []).append(p)
            for (_, dtype, count), params in by_kind.items():
                def c(x):
                    return rounded(x, dtype)

                grads = [p.grad for p in params]
                mus = [self.state[p]["mu"] for p in params]
                nus = [self.state[p]["nu"] for p in params]
                g = torch._foreach_add(grads, torch._foreach_mul(params, c(group["weight_decay"])))
                torch._foreach_mul_(mus, c(b1))
                torch._foreach_add_(mus, torch._foreach_mul(g, c(1 - b1)))
                g2 = torch._foreach_mul(g, g)
                torch._foreach_mul_(g2, c(1 - b2))
                torch._foreach_mul_(nus, c(b2))
                torch._foreach_add_(nus, g2)
                bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
                bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
                u = torch._foreach_div(mus, c(bc1))
                den = torch._foreach_div(nus, c(bc2))
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, c(group["eps"]))
                torch._foreach_div_(u, den)
                torch._foreach_mul_(u, -c(group["lr"]))
                torch._foreach_add_(params, u)
        return loss


def make_optimizer(params, learning_rate: float, weight_decay: float = 1e-4,
                   b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> torch.optim.Optimizer:
    """torch.optim.Adam for float32 parameters, ChainAdam for any other
    parameter dtype (bf16: model.param_dtype=bfloat16)."""
    params = list(params)
    tensors = [p for item in params
               for p in (item["params"] if isinstance(item, dict) else [item])]
    cls = (torch.optim.Adam if all(p.dtype == torch.float32 for p in tensors)
           else ChainAdam)
    return cls(params, lr=float(learning_rate), betas=(b1, b2), eps=eps,
               weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
