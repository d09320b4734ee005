"""SELD CRNN: CNN encoder, bidirectional GRU, grid head (counterpart:
seld_tpu/models/crnn.py).

ConvBlocks pool frequency 64 -> 4 and keep time; a stacked bidirectional
GRU (hidden 256, 2 layers) with dropout between layers only; the grid
head (Linear 512, LayerNorm, ReLU, Dropout, Linear to M x G).

The recurrence. The JAX package runs flax's GRUCell under nn.RNN, a
lax.scan, not a Pallas kernel, so torch.nn.GRU (cuDNN's GRU on the card)
is its counterpart here. flax's cell has input biases on r, z and n and a
hidden bias on n only; torch's carries hidden biases on all three gates,
of which the r and z ones add to the input ones: the same function, and
2 x hidden more parameters per direction and layer. Those r and z rows of
`bias_hh` are held at zero (state_dict_from_jax loads them as zeros, a new
model starts with them zeroed) and out of the update: a gradient hook
zeroes their rows, so Adam moves the effective r/z bias exactly as far as
optax moves flax's input bias, and a zero value with a zero gradient takes
no coupled-L2 step either. The parameters stay, so the state_dict keeps
its layout. Each layer is its own single-layer bidirectional
nn.GRU, so that the dropout between layers draws from the model's own
generator like every other Dropout (nn.GRU's own dropout would draw from
the global one). The recurrence runs in float32 whatever the compute
dtype, with its float32 parameters as they are: cuDNN's GRU does take bf16
on the H100, but that needs a bf16 copy of the weights on every call, and
flax's cell keeps its carry in float32 too. With bf16 parameters
(model.param_dtype=bfloat16, bf16 compute only: models.registry refuses
float32 compute, as flax's scan does) the recurrence stays float32 over
exact float32 copies of the weights, made per call (`_run_gru`); the
gradient reaches the bf16 parameters through the copies. The encoder's
output is read as float32, and the GRU's output is cast back to the
compute dtype.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn

from seld_tpu_torch import no_tf32
from seld_tpu_torch.models.layers import CNNEncoder, Dropout, DropoutSeeding, GridHead


def _run_gru(gru: nn.GRU, x: torch.Tensor) -> torch.Tensor:
    """gru(x)'s output in float32: the module itself for float32 weights,
    else the same single-layer bidirectional GRU on float32 copies of its
    weights (torch._VF.gru, the call nn.GRU.forward makes)."""
    if gru.weight_ih_l0.dtype == torch.float32:
        return gru(x)[0]
    h0 = x.new_zeros((2, x.shape[0], gru.hidden_size))
    weights = [w.float() for w in gru._flat_weights]
    return torch._VF.gru(x, h0, weights, True, 1, 0.0, gru.training, True, True)[0]


def _zero_rz_rows(hidden: int, grad: torch.Tensor) -> torch.Tensor:
    """The gradient of a GRU's hidden bias [r|z|n] with its r and z rows
    zeroed."""
    grad = grad.clone()
    grad[:2 * hidden] = 0
    return grad


class BiGRU(nn.Module):
    """Stacked bidirectional GRU on (B, T, D): per layer the forward and
    the time-reversed GRU concatenate, (B, T, 2 * hidden); dropout between
    layers only."""

    def __init__(self, in_features: int, hidden: int, num_layers: int = 2,
                 dropout: float = 0.3, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layers = nn.ModuleList(
            nn.GRU(in_features if i == 0 else 2 * hidden, hidden, batch_first=True,
                   bidirectional=True)
            for i in range(num_layers)
        )
        self.drops = nn.ModuleList(Dropout(dropout) for _ in range(num_layers - 1))
        self.hidden = hidden
        with torch.no_grad():
            for bias in self._rz_biases():
                bias[:2 * hidden].zero_()

    def _rz_biases(self):
        return [getattr(gru, name) for gru in self.layers
                for name in ("bias_hh_l0", "bias_hh_l0_reverse")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled():
            # registered here, not once in __init__: a deep copy of a
            # parameter drops its hooks
            for bias in self._rz_biases():
                if not bias._backward_hooks:
                    bias.register_hook(functools.partial(_zero_rz_rows, self.hidden))
        x = x.float()
        for i, gru in enumerate(self.layers):
            x = _run_gru(gru, x)
            if i < len(self.drops):
                x = self.drops[i](x)
        return x.to(self.compute_dtype)


class SELDCRNN(DropoutSeeding, nn.Module):
    """(B, T, C, F) features -> (B, T, M, G) class-major float32 logits."""

    def __init__(self, grid_size=(18, 36), num_classes: int = 14,
                 cnn_channels=(64, 128, 256, 512), rnn_hidden: int = 256,
                 rnn_layers: int = 2, n_channels: int = 4, n_mels: int = 64,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.3,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.encoder = CNNEncoder(n_channels, tuple(cnn_channels), n_mels, compute_dtype,
                                  norm_dtype)
        self.rnn = BiGRU(self.encoder.out_features, rnn_hidden, rnn_layers, dropout,
                         compute_dtype)
        self.head = GridHead(2 * rnn_hidden, 512, grid_size[0] * grid_size[1], num_classes,
                             compute_dtype, dropout, norm_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a float32 model is true float32: no TF32, for this call only
        with no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            x = self.encoder(x.to(self.compute_dtype).permute(0, 2, 1, 3))
            return self.head(self.rnn(x))
