"""SELD CSPDarkNet, the "cnn" model type (counterpart:
seld_tpu/models/cspdarknet.py).

Time folds into the batch, so each frame is a (F, 1) image with the
feature channels as its channels (NCHW: (B*T, C, F, 1)). A YOLOv5-style
backbone (Conv + BN + SiLU units, residual bottlenecks, CSP C3 blocks,
SPPF; depth and width multiples (0.33, 0.5) when `use_small`) gives P2-P5.
P3, P4 and P5 pass through 1x1 reductions to 256 channels; P4 and P5 are
resized bilinearly to P3's size, as jax.image.resize does it
(ops/pooling.bilinear_resize); then a 3x3 and a 1x1 fuse, the adaptive
average pool onto the (I, J) direction grid (ops/pooling), a per-cell L2
normalisation and a shared per-cell classifier 256 -> 128 -> M, emitted
class-major.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from seld_tpu_torch import no_tf32
from seld_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    Dropout,
    DropoutSeeding,
    LayerNorm,
    Linear,
)
from seld_tpu_torch.ops.pooling import adaptive_avg_pool_2d, bilinear_resize

STAGE_CHANNELS = (128, 256, 512, 1024)
STAGE_BLOCKS = (3, 6, 9, 3)


def _scaled(c: int, width: float) -> int:
    return max(round(c * width), 1)


def scaled_depth(n: int, depth: float) -> int:
    """Bottlenecks in a C3 block of n at depth multiple `depth`."""
    return max(round(n * depth), 1)


class ConvBnSiLU(nn.Module):
    """Conv (no bias) -> BatchNorm -> SiLU, returned in the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = Conv2d(in_channels, out_channels, kernel, stride=stride,
                           padding=padding, compute_dtype=compute_dtype)
        self.bn = BatchNorm(out_channels, norm_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x))).to(self.compute_dtype)


class CSPBottleneck(nn.Module):
    """1x1 -> 3x3, with the residual where the widths agree."""

    def __init__(self, in_channels: int, features: int, shortcut: bool = True, **dt):
        super().__init__()
        self.cv1 = ConvBnSiLU(in_channels, features, 1, 1, 0, **dt)
        self.cv2 = ConvBnSiLU(features, features, 3, 1, 1, **dt)
        self.residual = shortcut and in_channels == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.residual else y


class C3(nn.Module):
    """CSP block: bottlenecks on one half, a 1x1 on the other, a 1x1 over
    both."""

    def __init__(self, in_channels: int, features: int, n_blocks: int = 1, **dt):
        super().__init__()
        hidden = features // 2
        self.cv1 = ConvBnSiLU(in_channels, hidden, **dt)
        self.m = nn.ModuleList(CSPBottleneck(hidden, hidden, **dt) for _ in range(n_blocks))
        self.cv2 = ConvBnSiLU(in_channels, hidden, **dt)
        self.cv3 = ConvBnSiLU(2 * hidden, features, **dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for block in self.m:
            a = block(a)
        return self.cv3(torch.cat([a, self.cv2(x)], dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained 5x5 max-pools."""

    def __init__(self, in_channels: int, features: int, kernel: int = 5, **dt):
        super().__init__()
        hidden = in_channels // 2
        self.kernel = kernel
        self.cv1 = ConvBnSiLU(in_channels, hidden, **dt)
        self.cv2 = ConvBnSiLU(4 * hidden, features, **dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        pooled = [x]
        for _ in range(3):
            pooled.append(F.max_pool2d(pooled[-1], self.kernel, stride=1,
                                       padding=self.kernel // 2))
        return self.cv2(torch.cat(pooled, dim=1))


class CSPDarkNet(nn.Module):
    """Stem and 4 stages -> [P2, P3, P4, P5]."""

    def __init__(self, in_channels: int, depth: float = 1.0, width: float = 1.0, **dt):
        super().__init__()
        ch = _scaled(64, width)
        self.stem = ConvBnSiLU(in_channels, ch, 3, 1, 1, **dt)
        for stage, (c, n) in enumerate(zip(STAGE_CHANNELS, STAGE_BLOCKS)):
            out = _scaled(c, width)
            self.add_module(f"down{stage}", ConvBnSiLU(ch, out, 3, 2, 1, **dt))
            self.add_module(f"c3_{stage}", C3(out, out, scaled_depth(n, depth), **dt))
            ch = out
        self.sppf = SPPF(ch, _scaled(1024, width), **dt)
        self.out_channels = [_scaled(c, width) for c in STAGE_CHANNELS]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem(x)
        feats = []
        for stage in range(len(STAGE_CHANNELS)):
            x = getattr(self, f"c3_{stage}")(getattr(self, f"down{stage}")(x))
            if stage == len(STAGE_CHANNELS) - 1:
                x = self.sppf(x)
            feats.append(x)
        return feats


class SELDCSPDarkNet(DropoutSeeding, nn.Module):
    """(B, T, C, F) features -> (B, T, M, G) class-major float32 logits."""

    def __init__(self, grid_size=(18, 36), num_classes: int = 14, use_small: bool = True,
                 n_channels: int = 4, compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.3, norm_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.grid_size = tuple(grid_size)
        self.num_classes = num_classes
        dt = dict(compute_dtype=compute_dtype, norm_dtype=norm_dtype)
        depth, width = (0.33, 0.5) if use_small else (1.0, 1.0)
        self.backbone = CSPDarkNet(n_channels, depth, width, **dt)
        p3, p4, p5 = self.backbone.out_channels[1:]
        self.reduce_p3 = Conv2d(p3, 256, 1, compute_dtype=compute_dtype, bias=True)
        self.reduce_p4 = Conv2d(p4, 256, 1, compute_dtype=compute_dtype, bias=True)
        self.reduce_p5 = Conv2d(p5, 256, 1, compute_dtype=compute_dtype, bias=True)
        self.fuse1 = ConvBnSiLU(3 * 256, 512, 3, 1, 1, **dt)
        self.fuse2 = ConvBnSiLU(512, 256, 1, 1, 0, **dt)
        self.cls1 = Linear(256, 128, compute_dtype=compute_dtype)
        self.cls_norm = LayerNorm(128, norm_dtype)
        self.drop = Dropout(dropout)
        self.cls2 = Linear(128, num_classes, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext():
            dt = self.compute_dtype
            b, t, c, f = x.shape
            x = x.to(dt).reshape(b * t, c, f, 1)  # each frame an (F, 1) image
            _, p3, p4, p5 = self.backbone(x)
            p3 = self.reduce_p3(p3)
            size = tuple(p3.shape[-2:])
            fused = torch.cat([p3, bilinear_resize(self.reduce_p4(p4), size).to(dt),
                               bilinear_resize(self.reduce_p5(p5), size).to(dt)], dim=1)
            fused = self.fuse2(self.fuse1(fused))
            grid = adaptive_avg_pool_2d(fused, self.grid_size)  # (B*T, 256, I, J)
            grid = grid.flatten(2).transpose(1, 2).float()  # (B*T, G, 256)
            # per-cell L2 normalisation in float32
            grid = grid / grid.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            y = torch.relu(self.cls_norm(self.cls1(grid.to(dt)))).to(dt)
            y = self.cls2(self.drop(y)).float()
            return y.view(b, t, -1, self.num_classes).transpose(2, 3).contiguous()
