"""Waveform -> log-mel features (counterpart: seld_tpu/data/corpus.py,
`compute_mel_features` and `features_from_frames`).

Framing is a strided view of the reflect-padded signal on the device;
the frames then go through K1 (seld_tpu_torch.ops.mel_cuda) in one
launch per `_FRAME_CHUNK` frames. K1 treats every frame on its own, so
the chunk only bounds device memory: the JAX package's 128/1024/8192
tiers exist for XLA's static shapes and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from seld_tpu_torch import resolve_device
from seld_tpu_torch.config import FeatureConfig
from seld_tpu_torch.features.mel import frame_signal
from seld_tpu_torch.ops.mel_cuda import log_mel_frames

_FRAME_CHUNK = 1 << 16  # frames per K1 launch: 250 MB of f32 input


def compute_mel_features(wave, feat: FeatureConfig,
                         device: str | torch.device | None = None) -> torch.Tensor:
    """(C, N) waveform (numpy or tensor) -> (T, C, n_mels) float32 features
    on `device` (CUDA unless named), T = 1 + N // hop."""
    device = resolve_device(device)
    if not torch.is_tensor(wave):
        wave = torch.from_numpy(np.asarray(wave, np.float32))
    x = wave.to(device=device, dtype=torch.float32)
    return features_from_frames(frame_signal(x, feat.n_fft, feat.hop_length), feat)


def features_from_frames(frames: torch.Tensor, feat: FeatureConfig) -> torch.Tensor:
    """(C, T, n_fft) frames -> (T, C, n_mels) log-mel features, time-major
    so that window slicing is a view of the leading axis."""
    if feat.feature_set != "mel":
        raise NotImplementedError(
            f"feature_set={feat.feature_set!r} needs the spatial front-end "
            "kernel K4, which is not ported yet (ROADMAP: spatial features)"
        )
    c, t, nf = frames.shape
    flat = frames.reshape(c * t, nf).contiguous()
    out = torch.cat([
        log_mel_frames(
            flat[start:start + _FRAME_CHUNK], n_fft=feat.n_fft,
            n_mels=feat.n_mels, sample_rate=feat.sample_rate,
            f_min=feat.f_min, f_max=feat.f_max, amin=feat.amin,
        )
        for start in range(0, c * t, _FRAME_CHUNK)
    ])
    return out.reshape(c, t, feat.n_mels).transpose(0, 1).contiguous()
