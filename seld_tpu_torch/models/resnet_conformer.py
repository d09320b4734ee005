"""SELD ResNet50-Conformer, the flagship backbone (counterpart:
seld_tpu/models/resnet_conformer.py).

An audio ResNet50 (C-channel input: 4 log-mel planes, 7 with the FOA
intensity vectors, 10 with GCC-PHAT; 3x3 stem, every stride (1, 2) on
(T, F) so time is kept while frequency goes 64 -> 2; bottleneck counts
[3, 4, 6, 3]) feeds d_model-wide Conformer blocks and a 1024-hidden grid
head. The public input is (B, T, C, F) as in the JAX package; inside,
the encoder runs NCHW on (B, C, T, F).

norm_dtype goes to every BatchNorm and LayerNorm; remat ("resnet": each
bottleneck, "conformer": each conformer block, "all": both) recomputes
those blocks' activations in the backward (layers.run_block), as the JAX
model's nn.remat does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from seld_tpu_torch import no_tf32
from seld_tpu_torch.models.layers import (
    BatchNorm,
    ConformerBlock,
    Conv2d,
    Dropout,
    DropoutSeeding,
    GridHead,
    Linear,
    run_block,
)
from seld_tpu_torch.parallel.sequence import halo_exchange, time_mesh

RESNET50_LAYERS = (3, 4, 6, 3)
RESNET50_PLANES = (64, 128, 256, 512)
EXPANSION = 4


def _halve(n: int) -> int:
    """Size after a 3-wide window at stride 2 with padding 1."""
    return (n - 1) // 2 + 1


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 (frequency stride) -> 1x1 expand (4x), with a
    projected shortcut where the shape changes; residual + ReLU."""

    def __init__(self, in_channels: int, planes: int, stride=(1, 1),
                 compute_dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = planes * EXPANSION
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2d(in_channels, planes, 1, compute_dtype=compute_dtype)
        self.bn1 = BatchNorm(planes, norm_dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            compute_dtype=compute_dtype)
        self.bn2 = BatchNorm(planes, norm_dtype)
        self.conv3 = Conv2d(planes, out_ch, 1, compute_dtype=compute_dtype)
        self.bn3 = BatchNorm(out_ch, norm_dtype)
        if in_channels != out_ch or tuple(stride) != (1, 1):
            self.downsample = Conv2d(in_channels, out_ch, 1, stride=stride,
                                     compute_dtype=compute_dtype)
            self.downsample_bn = BatchNorm(out_ch, norm_dtype)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = torch.relu(self.bn1(self.conv1(x))).to(dt)
        y = torch.relu(self.bn2(self.conv2(y))).to(dt)
        y = self.bn3(self.conv3(y)).to(dt)
        identity = x
        if self.downsample is not None:
            identity = self.downsample_bn(self.downsample(x)).to(dt)
        return torch.relu(y + identity)


class ResNet50Encoder(nn.Module):
    """(B, C, T, F) -> (B, 2048, T, F/32): 3x3 stem at stride (1, 2), 3x3
    max-pool at stride (1, 2), then stages [3, 4, 6, 3] with frequency-only
    striding in stages 2-4. Blocks are named stage{s}_block{b}; with remat
    each is recomputed in the backward."""

    def __init__(self, in_channels: int = 4, layers=RESNET50_LAYERS,
                 compute_dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.stem = Conv2d(in_channels, 64, 3, stride=(1, 2), padding=1,
                           compute_dtype=compute_dtype)
        self.stem_bn = BatchNorm(64, norm_dtype)
        self.block_names = []
        ch = 64
        strides = ((1, 1), (1, 2), (1, 2), (1, 2))
        for stage, (planes, stride, n) in enumerate(
            zip(RESNET50_PLANES, strides, layers), start=1
        ):
            for block in range(n):
                name = f"stage{stage}_block{block}"
                self.add_module(name, BottleneckBlock(
                    ch, planes, stride if block == 0 else (1, 1), compute_dtype, norm_dtype
                ))
                self.block_names.append(name)
                ch = planes * EXPANSION
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.stem_bn(self.stem(x))).to(self.compute_dtype)
        mesh = time_mesh()
        if mesh is None:
            x = F.max_pool2d(x, 3, stride=(1, 2), padding=1)
        else:  # time chunks: the neighbours' edge rows, -inf at the window's ends
            x = halo_exchange(x, 2, 1, float("-inf"), mesh)
            x = F.max_pool2d(x, 3, stride=(1, 2), padding=(0, 1))
        for name in self.block_names:
            x = run_block(getattr(self, name), x, self.remat)
        return x


class SELDResNetConformer(DropoutSeeding, nn.Module):
    """(B, T, C, F) features -> (B, T, M, G) class-major float32 logits."""

    def __init__(self, grid_size=(18, 36), num_classes: int = 14,
                 d_model: int = 512, n_heads: int = 8, n_layers: int = 4,
                 kernel_size: int = 31, n_channels: int = 4, n_mels: int = 64,
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.3,
                 norm_dtype: torch.dtype = torch.float32, remat: str = "none"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat_blocks = remat in ("conformer", "all")
        self.encoder = ResNet50Encoder(n_channels, compute_dtype=compute_dtype,
                                       norm_dtype=norm_dtype,
                                       remat=remat in ("resnet", "all"))
        f_out = n_mels
        for _ in range(5):  # stem, max-pool and stages 2-4 each halve F
            f_out = _halve(f_out)
        self.proj = Linear(self.encoder.out_channels * f_out, d_model,
                           compute_dtype=compute_dtype)
        self.drop = Dropout(dropout)
        self.blocks = nn.ModuleList(
            ConformerBlock(d_model, n_heads, 4 * d_model, kernel_size, compute_dtype,
                           dropout, norm_dtype)
            for _ in range(n_layers)
        )
        self.head = GridHead(d_model, 1024, grid_size[0] * grid_size[1],
                             num_classes, compute_dtype, dropout, norm_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a float32 model is true float32: no TF32, for this call only
        with no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            x = self.encoder(x.to(self.compute_dtype).permute(0, 2, 1, 3))
            b, c, t, f = x.shape
            # channel-major flatten of (C', F'), as the JAX model flattens
            x = self.drop(self.proj(x.permute(0, 2, 1, 3).reshape(b, t, c * f)))
            for block in self.blocks:
                x = run_block(block, x, self.remat_blocks)
            return self.head(x)
