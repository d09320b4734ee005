"""Kernel K1: STFT frames -> log-mel dB (CUDA C++, csrc/mel_kernel.cu).

Replaces seld_tpu/ops/mel_pallas.py::log_mel_frames_pallas. The kernel
computes re = frames @ C_re, im = frames @ C_im (Hann window folded into
the DFT bases), mel = (re^2 + im^2) @ FB and 10*log10(max(mel, amin)),
keeping the power spectrum on chip. `log_mel_frames` launches it for CUDA
tensors; for CPU tensors, and only for those, it runs
`log_mel_frames_reference`, the same arithmetic as three PyTorch GEMMs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from seld_tpu_torch.features.mel import hann_window, mel_filterbank

KERNEL_MELS = 64  # the kernel's filterbank width: n_mels is padded to it
_BIN_TILE = 64  # the kernel's spectrum chunk: n_bins is padded to it
_DEPTH_TILE = 16  # the kernel's DFT depth step: n_fft must divide by it


@functools.lru_cache(maxsize=8)
def dft_mel_constants(n_fft: int, n_mels: int, sample_rate: int,
                      f_min: float, f_max: float | None,
                      device: torch.device):
    """(C_re, C_im, FB) float32 on `device`, built once per arguments.

    C_re/C_im: (n_fft, n_bins) Hann-windowed DFT bases, the n_fft//2 + 1
    bins zero-padded to a multiple of 64. FB: (n_bins, >= 64) filterbank,
    n_mels zero-padded to a multiple of 64. Callers must not write to them.
    """
    n_freqs = n_fft // 2 + 1
    n_bins = -(-n_freqs // _BIN_TILE) * _BIN_TILE
    width = -(-n_mels // KERNEL_MELS) * KERNEL_MELS
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    win = hann_window(n_fft).astype(np.float64)[:, None]
    c_re = np.zeros((n_fft, n_bins), np.float32)
    c_im = np.zeros((n_fft, n_bins), np.float32)
    c_re[:, :n_freqs] = win * np.cos(ang)
    c_im[:, :n_freqs] = win * np.sin(ang)
    fb = np.zeros((n_bins, width), np.float32)
    fb[:n_freqs, :n_mels] = mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)
    return tuple(torch.from_numpy(a).to(device) for a in (c_re, c_im, fb))


def log_mel_frames_reference(frames: torch.Tensor, n_mels: int = 64,
                             sample_rate: int = 24_000, f_min: float = 0.0,
                             f_max: float | None = None,
                             amin: float = 1e-10) -> torch.Tensor:
    """The plain version of K1: (N, n_fft) f32 -> (N, n_mels) f32 dB,
    with the kernel's constants, as GEMMs in float32."""
    c_re, c_im, fb = dft_mel_constants(
        frames.shape[1], n_mels, sample_rate, f_min, f_max, frames.device
    )
    re = frames @ c_re
    im = frames @ c_im
    mel = (re * re + im * im) @ fb
    return (10.0 * torch.log10(torch.clamp_min(mel, amin)))[:, :n_mels].contiguous()


def _check_frames(frames: torch.Tensor, n_fft: int) -> None:
    if frames.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 frames, got {frames.dtype}")
    if frames.dim() != 2 or frames.shape[1] != n_fft:
        raise ValueError(
            f"K1 takes (N, {n_fft}) frames, got {tuple(frames.shape)}"
        )
    if not frames.is_contiguous():
        raise ValueError("K1 takes contiguous frames")
    if n_fft % _DEPTH_TILE:
        raise ValueError(f"K1 needs n_fft divisible by {_DEPTH_TILE}, got {n_fft}")


@functools.cache
def _kernel():
    from seld_tpu_torch.ops._build import load_library

    fn = load_library("mel_kernel").seld_log_mel_frames
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def log_mel_frames(frames: torch.Tensor, n_fft: int = 960, n_mels: int = 64,
                   sample_rate: int = 24_000, f_min: float = 0.0,
                   f_max: float | None = None,
                   amin: float = 1e-10) -> torch.Tensor:
    """(N, n_fft) float32 contiguous STFT frames -> (N, n_mels) float32
    log-mel dB.

    A CUDA tensor goes through kernel K1 on the current stream (every
    launch adds one to `log_mel_frames.launches`); a CPU tensor goes
    through `log_mel_frames_reference`. Anything else raises."""
    _check_frames(frames, n_fft)
    if frames.device.type == "cpu":
        return log_mel_frames_reference(
            frames, n_mels, sample_rate, f_min, f_max, amin
        )
    if frames.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {frames.device}")
    if n_mels > KERNEL_MELS:
        raise ValueError(f"K1 computes at most {KERNEL_MELS} mels, got {n_mels}")
    if frames.data_ptr() % 16:
        raise ValueError("K1 needs 16-byte aligned frames")
    c_re, c_im, fb = dft_mel_constants(
        n_fft, n_mels, sample_rate, f_min, f_max, frames.device
    )
    out = torch.empty((frames.shape[0], n_mels), dtype=torch.float32,
                      device=frames.device)
    if frames.shape[0] == 0:
        return out
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = _kernel()(
            frames.data_ptr(), c_re.data_ptr(), c_im.data_ptr(), fb.data_ptr(),
            out.data_ptr(), frames.shape[0], n_fft, c_re.shape[1], n_mels,
            amin, stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed with CUDA error {rc}")
    log_mel_frames.launches += 1
    return out


log_mel_frames.launches = 0
