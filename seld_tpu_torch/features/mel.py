"""Plain log-mel front-end (counterpart: seld_tpu/features/mel.py).

torchaudio MelSpectrogram(n_fft=960, hop_length=480, n_mels=64) followed by
AmplitudeToDB, per channel: periodic Hann window, center=True with reflect
padding of n_fft//2, power 2, HTK mel filterbank with norm=None, then
10*log10(max(x, amin)). The serving path computes the same function with
kernel K1 (seld_tpu_torch.ops.mel_cuda); this rFFT version is its oracle.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n_fft: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (torch.hann_window's default)."""
    n = np.arange(n_fft, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))).astype(dtype)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    n_freqs: int,
    n_mels: int,
    sample_rate: int,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> np.ndarray:
    """(n_freqs, n_mels) float32 triangular HTK-mel filterbank, norm=None:
    n_mels + 2 mel-spaced breakpoints; filter m rises from breakpoint m to
    m+1 and falls to m+2. The cached array is shared: do not write to it."""
    if f_max is None:
        f_max = sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=np.float64)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def num_stft_frames(n_samples: int, hop_length: int) -> int:
    """Frame count of a center-padded STFT: 1 + n_samples // hop."""
    return 1 + n_samples // hop_length


def reflect_indices(n: int, pad: int) -> np.ndarray:
    """Source index of each sample of an n-sample signal reflect-padded by
    `pad` on both sides, as np.pad(mode="reflect") builds it for any pad:
    the index folded with period 2(n - 1), and sample 0 repeated when
    n = 1."""
    pos = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(pos)
    period = 2 * (n - 1)
    folded = np.mod(pos, period)
    return np.where(folded >= n, period - folded, folded)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(..., n) signal -> (..., T, n_fft) center-padded frames, a strided
    view of the reflect-padded signal, T = 1 + n // hop. A signal of at most
    n_fft // 2 samples reflects more than once, as np.pad does: its padded
    buffer is one index gather on the signal's device."""
    lead, n = x.shape[:-1], x.shape[-1]
    t_frames = num_stft_frames(n, hop_length)
    pad = n_fft // 2
    flat = x.reshape(-1, n)
    if n > pad:
        flat = F.pad(flat, (pad, pad), mode="reflect")
    else:
        flat = flat[:, torch.from_numpy(reflect_indices(n, pad)).to(x.device)]
    need = (t_frames - 1) * hop_length + n_fft
    if flat.shape[-1] < need:
        flat = F.pad(flat, (0, need - flat.shape[-1]))
    frames = flat.unfold(-1, n_fft, hop_length)[:, :t_frames]
    return frames.reshape(*lead, t_frames, n_fft)


def amplitude_to_db(power: torch.Tensor, amin: float = 1e-10) -> torch.Tensor:
    """Power -> dB: 10*log10(max(x, amin))."""
    return 10.0 * torch.log10(torch.clamp_min(power, amin))


def log_mel_spectrogram(
    waveform: torch.Tensor,
    sample_rate: int = 24_000,
    n_fft: int = 960,
    hop_length: int = 480,
    n_mels: int = 64,
    f_min: float = 0.0,
    f_max: float | None = None,
    amin: float = 1e-10,
) -> torch.Tensor:
    """(..., n_samples) float32 -> (..., n_mels, T) log-mel dB."""
    frames = frame_signal(waveform, n_fft, hop_length)
    window = torch.as_tensor(hann_window(n_fft), device=waveform.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.as_tensor(
        mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max),
        device=waveform.device,
    )
    db = amplitude_to_db(power.float() @ fb, amin=amin)
    return db.transpose(-1, -2)
