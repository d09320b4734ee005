"""Spatial feature sets: FOA intensity vectors and GCC-PHAT
(counterpart: seld_tpu/features/spatial.py).

  * "mel"     — 4 log-mel channels
  * "mel_iv"  — + 3 FOA intensity-vector channels (7 in all): in ACN
    order (W, Y, Z, X), I(t, f) = Re{conj(W) [X, Y, Z]} over the energy
    of the bin, on the column-normalised mel filterbank;
  * "mel_gcc" — + 6 GCC-PHAT channels, one per channel pair (10 in all):
    the phase-transformed cross-spectrum conj(S_i) S_j taken back to the
    lag domain, n_mels lags centred on zero.

This is the rFFT version, the oracle that kernel K4
(seld_tpu_torch.ops.spatial_cuda) is held against, as in the JAX
package; the corpus and the predictor compute these features through K4.
"""

from __future__ import annotations

import functools
import itertools

import torch

from seld_tpu_torch.features.mel import hann_window, mel_filterbank

# STARSS22 FOA is ACN channel order: W, Y, Z, X.
_ACN_W, _ACN_Y, _ACN_Z, _ACN_X = 0, 1, 2, 3

FEATURE_CHANNELS = {"mel": 4, "mel_iv": 7, "mel_gcc": 10}


def feature_channels(feature_set: str, n_audio_channels: int = 4) -> int:
    """Total feature channels produced for a feature set."""
    if feature_set == "mel":
        return n_audio_channels
    if feature_set == "mel_iv":
        return n_audio_channels + 3
    if feature_set == "mel_gcc":
        return n_audio_channels + n_audio_channels * (n_audio_channels - 1) // 2
    raise ValueError(f"unknown feature_set {feature_set!r}")


# The window and the filterbank stay on their device once uploaded: a
# pageable host-to-device copy per call would block the host each time.
@functools.lru_cache(maxsize=8)
def _window(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(hann_window(n_fft), device=device)


@functools.lru_cache(maxsize=8)
def _filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                device: torch.device) -> torch.Tensor:
    return torch.as_tensor(mel_filterbank(n_freqs, n_mels, sample_rate), device=device)


def stft_frames(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Windowed rFFT of pre-framed audio: (..., T, n_fft) -> complex
    (..., T, n_fft//2+1)."""
    return torch.fft.rfft(frames * _window(n_fft, frames.device), dim=-1)


def log_mel_from_spec(spec: torch.Tensor, n_mels: int, sample_rate: int,
                      amin: float = 1e-10) -> torch.Tensor:
    """Power of a complex spectrum -> log-mel dB: (..., T, F) -> (..., T, n_mels)."""
    power = spec.real.square() + spec.imag.square()
    fb = _filterbank(spec.shape[-1], n_mels, sample_rate, spec.device)
    return 10.0 * torch.log10(torch.clamp_min(power.float() @ fb, amin))


def foa_intensity_mel(spec: torch.Tensor, n_mels: int, sample_rate: int,
                      eps: float = 1e-8) -> torch.Tensor:
    """FOA acoustic intensity vector on mel bands: complex (4, T, F) in ACN
    order -> float32 (T, 3, n_mels), components (X, Y, Z)."""
    w = spec[_ACN_W]
    xyz = torch.stack([spec[_ACN_X], spec[_ACN_Y], spec[_ACN_Z]])  # (3, T, F)
    intensity = (torch.conj(w)[None] * xyz).real
    energy = (w.abs().square() + xyz.abs().square().mean(dim=0)) / 2.0 + eps
    fb = _filterbank(spec.shape[-1], n_mels, sample_rate, spec.device)
    fb_norm = fb / torch.clamp_min(fb.sum(dim=0, keepdim=True), eps)
    iv_mel = (intensity / energy[None]).float() @ fb_norm  # (3, T, n_mels)
    return iv_mel.transpose(0, 1)


def gcc_phat_features(spec: torch.Tensor, n_lags: int, eps: float = 1e-8) -> torch.Tensor:
    """GCC-PHAT lag features of every channel pair: complex (C, T, F)
    one-sided spectra -> float32 (T, C(C-1)/2, n_lags), lags
    [-n_lags//2, n_lags//2) in order."""
    pairs = list(itertools.combinations(range(spec.shape[0]), 2))
    # conj(S_i) S_j: a positive lag means channel j lags channel i
    cross = (torch.conj(torch.stack([spec[i] for i, _ in pairs]))
             * torch.stack([spec[j] for _, j in pairs]))
    cross = cross / torch.clamp_min(cross.abs(), eps)
    corr = torch.fft.irfft(cross, dim=-1)  # (P, T, n_fft)
    half = n_lags // 2
    centred = torch.cat([corr[..., -half:], corr[..., :n_lags - half]], dim=-1)
    return centred.float().transpose(0, 1)


def extract_feature_frames(frames: torch.Tensor, feature_set: str, n_fft: int,
                           n_mels: int, sample_rate: int,
                           amin: float = 1e-10) -> torch.Tensor:
    """Framed audio (C, T, n_fft) -> (T, C_out, n_mels) feature stack."""
    spec = stft_frames(frames, n_fft)  # (C, T, F)
    feats = [log_mel_from_spec(spec, n_mels, sample_rate, amin).transpose(0, 1)]
    if feature_set == "mel_iv":
        feats.append(foa_intensity_mel(spec, n_mels, sample_rate))
    elif feature_set == "mel_gcc":
        feats.append(gcc_phat_features(spec, n_lags=n_mels))
    elif feature_set != "mel":
        raise ValueError(f"unknown feature_set {feature_set!r}")
    return torch.cat(feats, dim=1)
