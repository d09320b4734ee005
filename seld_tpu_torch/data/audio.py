"""WAV decoding and writing (counterpart: seld_tpu/data/audio.py,
`load_wav_python` and `write_wav`).

The standard library's `wave` decoder: PCM with 8, 16, 24 or 32-bit
integer samples, scaled to [-1, 1]. IEEE-float and EXTENSIBLE WAVs are
not read yet (ROADMAP: known gaps).
"""

from __future__ import annotations

import logging
import wave
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def load_wav(path, expected_channels: int | None = 4):
    """Decode a PCM WAV file -> (float32 (C, N) in [-1, 1], sample rate)."""
    with wave.open(str(path), "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals & 0x800000, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / 8388608.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {sampwidth} in {path}")

    wave_cn = data.reshape(n_frames, n_channels).T.copy()
    if expected_channels is not None and n_channels != expected_channels:
        logger.warning(
            "Expected %d channels but got %d channels in %s",
            expected_channels, n_channels, path,
        )
    return wave_cn, sr


def write_wav(path, waveform: np.ndarray, sample_rate: int) -> None:
    """Write float32 (C, N) in [-1, 1] as 16-bit PCM."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(waveform * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(waveform.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())
