"""Building blocks of the grid backbones (counterpart:
seld_tpu/models/layers.py).

Dtype policy, as in the JAX package: parameters are float32; convolutions
and linears cast their input and weights to the compute dtype; BatchNorm
and LayerNorm run in float32 and return float32, and the caller casts back
to the compute dtype where the JAX module does. Sequence tensors are
(B, T, D).

Train mode (`module.train()`): BatchNorm normalises by the batch's
statistics and updates its running ones; Dropout draws its keep-mask from
an explicit torch.Generator (SELDResNetConformer.seed_dropout), never from
the global one. Eval mode uses the running statistics and no dropout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from seld_tpu_torch.ops.attention import multi_head_attention

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # running = 0.9 * running + 0.1 * batch (flax momentum 0.9)
LN_EPS = 1e-5


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Linear(nn.Linear):
    """nn.Linear whose product runs in `compute_dtype`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (no bias) whose convolution runs in `compute_dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride=1, padding: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)


class DepthwiseConv1d(nn.Conv1d):
    """Depthwise 'same' conv over time on (B, D, T), in `compute_dtype`."""

    def __init__(self, channels: int, kernel_size: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(channels, channels, kernel_size,
                         padding=kernel_size // 2, groups=channels)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.padding, groups=self.groups)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis in float32, returning float32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Dropout(nn.Module):
    """Inverted dropout whose keep-mask comes from `generator`, a
    torch.Generator on the input's device that the owner of the model sets
    and seeds. Identity in eval mode and at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "train-mode dropout needs a generator: call the model's "
                "seed_dropout(seed) first"
            )
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        return x / (1.0 - self.p) * keep


class BatchNorm(nn.Module):
    """BatchNorm over axis 1 in float32, returning float32. In train mode
    it normalises by the batch's mean and biased variance and moves the
    running statistics toward them by BN_MOMENTUM. The running variance
    takes the biased batch variance, as flax stores it; F.batch_norm
    gives the unbiased one, which is rescaled here."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False, eps=BN_EPS)
        # F.batch_norm writes momentum * (batch mean, unbiased batch variance)
        # into zeroed buffers (autograd saves them, so the module's own
        # statistics are updated apart); unbiased -> biased is (n - 1) / n
        n = x.numel() // x.shape[1]
        mean_step, var_step = torch.zeros((2, x.shape[1]), device=x.device).unbind(0)
        out = F.batch_norm(x, mean_step, var_step, self.weight, self.bias,
                           training=True, momentum=BN_MOMENTUM, eps=BN_EPS)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean_step)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var_step, alpha=(n - 1) / n)
        return out


class FeedForward(nn.Module):
    """Half-step Swish FFN with its residual: x + 0.5 * FFN(LN(x))."""

    def __init__(self, d_model: int, d_ff: int,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm = LayerNorm(d_model)
        self.fc1 = Linear(d_model, d_ff, compute_dtype=compute_dtype)
        self.fc2 = Linear(d_ff, d_model, compute_dtype=compute_dtype)
        self.drop1 = Dropout(dropout)
        self.drop2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(x).to(self.compute_dtype)
        y = self.drop1(swish(self.fc1(y)))
        return x + 0.5 * self.drop2(self.fc2(y))


class MultiHeadSelfAttention(nn.Module):
    """Pre-norm multi-head self-attention with its residual."""

    def __init__(self, d_model: int, n_heads: int,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not divisible by {n_heads} heads")
        self.compute_dtype = compute_dtype
        self.n_heads = n_heads
        self.norm = LayerNorm(d_model)
        self.w_q = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.w_k = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.w_v = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.w_o = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        y = self.norm(x).to(self.compute_dtype)

        def heads(proj):
            return proj(y).view(b, t, self.n_heads, d // self.n_heads).transpose(1, 2)

        out = multi_head_attention(heads(self.w_q), heads(self.w_k), heads(self.w_v))
        return x + self.drop(self.w_o(out.transpose(1, 2).reshape(b, t, d)))


class ConformerConvModule(nn.Module):
    """LN -> pointwise (2x) + GLU -> depthwise conv -> BN -> Swish ->
    pointwise, with its residual."""

    def __init__(self, d_model: int, kernel_size: int = 31,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm = LayerNorm(d_model)
        self.pw1 = Linear(d_model, 2 * d_model, compute_dtype=compute_dtype)
        self.depthwise = DepthwiseConv1d(d_model, kernel_size, compute_dtype=compute_dtype)
        self.bn = BatchNorm(d_model)
        self.pw2 = Linear(d_model, d_model, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw1(self.norm(x).to(self.compute_dtype))
        a, gate = y.chunk(2, dim=-1)
        y = self.depthwise((a * torch.sigmoid(gate)).transpose(1, 2))  # (B, D, T)
        y = swish(self.bn(y)).to(self.compute_dtype)
        return x + self.drop(self.pw2(y.transpose(1, 2)))


class ConformerBlock(nn.Module):
    """ff1 -> MHSA -> conv module -> ff2 -> final LayerNorm."""

    def __init__(self, d_model: int, n_heads: int = 4, d_ff: int | None = None,
                 kernel_size: int = 31,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.1):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.compute_dtype = compute_dtype
        self.ff1 = FeedForward(d_model, d_ff, compute_dtype, dropout)
        self.attn = MultiHeadSelfAttention(d_model, n_heads, compute_dtype, dropout)
        self.conv = ConformerConvModule(d_model, kernel_size, compute_dtype, dropout)
        self.ff2 = FeedForward(d_model, d_ff, compute_dtype, dropout)
        self.norm = LayerNorm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ff2(self.conv(self.attn(self.ff1(x))))
        return self.norm(x).to(self.compute_dtype)


class GridHead(nn.Module):
    """Linear -> LayerNorm -> ReLU -> Dropout -> Linear to class-major (B, T, M, G)
    float32 logits. `logits` holds the JAX (hidden, M, G) kernel as an
    (M*G, hidden) weight."""

    def __init__(self, in_features: int, hidden: int, grid_cells: int,
                 num_classes: int, compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.3):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_classes = num_classes
        self.grid_cells = grid_cells
        self.fc = Linear(in_features, hidden, compute_dtype=compute_dtype)
        self.norm = LayerNorm(hidden)
        self.logits = Linear(hidden, num_classes * grid_cells, compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm(self.fc(x))).to(self.compute_dtype)
        y = self.logits(self.drop(y))
        return y.view(*y.shape[:-1], self.num_classes, self.grid_cells).float()
