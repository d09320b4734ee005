"""SELD Conformer: CNN encoder, Conformer blocks, grid head (counterpart:
seld_tpu/models/conformer.py).

The CRNN's CNN encoder, a linear projection to d_model (256), n_layers
(2) Conformer blocks (half-step FFNs, 4-head self-attention, the
depthwise-conv module, kernel 31) and the 512-hidden grid head; all but
the head form the trunk that the ACCDOA families share. Attention
goes through seld_tpu_torch.ops.attention, so from T = 512 frames on
(20 s windows are T = 1000) a CUDA forward runs kernel K3. remat
("conformer" or "all") recomputes each block in the backward.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from seld_tpu_torch import no_tf32
from seld_tpu_torch.models.layers import (
    CNNEncoder,
    ConformerBlock,
    DropoutSeeding,
    GridHead,
    Linear,
    run_block,
)


class ConformerTrunk(DropoutSeeding, nn.Module):
    """The CNN encoder, the projection to d_model and the conformer blocks,
    shared by the grid Conformer and the ACCDOA families
    (seld_tpu_torch.accdoa): forward maps (B, T, C, F) features through
    them and `head`, which each subclass defines (a module or a method)."""

    def __init__(self, cnn_channels=(64, 128, 256, 512), d_model: int = 256,
                 n_heads: int = 4, n_layers: int = 2, kernel_size: int = 31,
                 n_channels: int = 4, n_mels: int = 64,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.3,
                 norm_dtype: torch.dtype = torch.float32, remat: str = "none"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat_blocks = remat in ("conformer", "all")
        self.encoder = CNNEncoder(n_channels, tuple(cnn_channels), n_mels, compute_dtype,
                                  norm_dtype)
        self.proj = Linear(self.encoder.out_features, d_model, compute_dtype=compute_dtype)
        self.blocks = nn.ModuleList(
            ConformerBlock(d_model, n_heads, 4 * d_model, kernel_size, compute_dtype,
                           dropout, norm_dtype)
            for _ in range(n_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a float32 model is true float32: no TF32, for this call only
        with no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            x = self.proj(self.encoder(x.to(self.compute_dtype).permute(0, 2, 1, 3)))
            for block in self.blocks:
                x = run_block(block, x, self.remat_blocks)
            return self.head(x)


class SELDConformer(ConformerTrunk):
    """(B, T, C, F) features -> (B, T, M, G) class-major float32 logits."""

    def __init__(self, grid_size=(18, 36), num_classes: int = 14,
                 cnn_channels=(64, 128, 256, 512), d_model: int = 256, n_heads: int = 4,
                 n_layers: int = 2, kernel_size: int = 31, n_channels: int = 4,
                 n_mels: int = 64, compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.3, norm_dtype: torch.dtype = torch.float32,
                 remat: str = "none"):
        super().__init__(cnn_channels, d_model, n_heads, n_layers, kernel_size, n_channels,
                         n_mels, compute_dtype, dropout, norm_dtype, remat)
        self.head = GridHead(d_model, 512, grid_size[0] * grid_size[1], num_classes,
                             compute_dtype, dropout, norm_dtype)
