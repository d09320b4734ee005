"""Kernel K4: 4-channel STFT frames -> spatial feature stack (CUDA C++,
csrc/spatial_kernel.cu).

Replaces seld_tpu/ops/spatial_pallas.py::spatial_features_pallas. For
each frame of the four FOA channels (ACN order W, Y, Z, X) the kernel
computes the Hann-windowed DFT as GEMMs and, without writing a spectrum
to device memory, 4 log-mel planes and either 3 energy-normalised
intensity-vector planes on the column-normalised filterbank ("mel_iv")
or 6 PHAT-normalised cross-spectra projected onto n_mels centred lags
("mel_gcc"). It computes what the TPU kernel computes, not the rFFT
oracle of seld_tpu_torch.features.spatial: GCC normalises with
rsqrt(cr^2 + ci^2 + eps^2), and padded bins give exact zeros.

Bound on an H100: the function's bytes (frames in, features out) at
3.35 TB/s; the kernel's own DFT-as-GEMM arithmetic in float32 FMA is what
it spends its time on (see the source). `spatial_features` launches it for
CUDA tensors, one launch per `MAX_LAUNCH_FRAMES` frames; for CPU tensors,
and only for those, it runs `spatial_features_reference`, the same
arithmetic as float32 GEMMs with the same padded constants.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from seld_tpu_torch.features.spatial import _ACN_W, _ACN_X, _ACN_Y, _ACN_Z, feature_channels
from seld_tpu_torch.ops.mel_cuda import KERNEL_MELS, dft_mel_constants

FEATURE_SETS = {"mel": 0, "mel_iv": 1, "mel_gcc": 2}
# frames per launch: 16,384 frames of 4 channels are 252 MB of input, so a
# clip of up to 5.4 minutes is one launch
MAX_LAUNCH_FRAMES = 1 << 14
_DEPTH_TILE = 16  # the kernel's DFT depth step: n_fft must divide by it
_PAIRS = list(itertools.combinations(range(4), 2))


@functools.lru_cache(maxsize=8)
def spatial_constants(n_fft: int, n_mels: int, sample_rate: int, device: torch.device):
    """(C_re, C_im, FB, FB_norm, LAG_re, LAG_im) float32 on `device`,
    built once per arguments; callers must not write to them.

    C_re, C_im and FB are those of K1's plain version
    (mel_cuda.dft_mel_constants): the DFT bases with the n_fft//2 + 1 bins
    zero-padded to a multiple of 64, and the (n_bins, 64) mel filterbank. FB_norm is FB with its columns divided by
    max(column sum, 1e-8); LAG_re/LAG_im, also (n_bins, 64), are the
    inverse one-sided DFT onto lags l - n_mels//2 (weights 1 at bins 0 and
    n_fft/2, else 2, over n_fft). All are zero outside the real bins and
    the n_mels columns."""
    c_re, c_im, fb = dft_mel_constants(n_fft, n_mels, sample_rate, 0.0, None, device)
    fb_np = fb.cpu().numpy()
    fb_norm = fb_np / np.maximum(fb_np.sum(axis=0, keepdims=True), 1e-8)

    n_freqs = n_fft // 2 + 1
    half = n_mels // 2
    lags = np.concatenate([np.arange(-half, 0), np.arange(0, n_mels - half)])
    kk = np.arange(n_freqs, dtype=np.float64)[:, None]
    w = np.full((n_freqs, 1), 2.0)
    w[0, 0] = 1.0
    if n_fft % 2 == 0:
        w[-1, 0] = 1.0
    phase = 2.0 * np.pi * kk * lags[None, :].astype(np.float64) / n_fft
    lag_re = np.zeros_like(fb_np)
    lag_im = np.zeros_like(fb_np)
    lag_re[:n_freqs, :n_mels] = w * np.cos(phase) / n_fft
    lag_im[:n_freqs, :n_mels] = -w * np.sin(phase) / n_fft
    return (c_re, c_im, fb,
            *(torch.from_numpy(a).to(device) for a in (fb_norm, lag_re, lag_im)))


def spatial_features_reference(frames: torch.Tensor, feature_set: str, n_mels: int = 64,
                               sample_rate: int = 24_000, amin: float = 1e-10,
                               eps: float = 1e-8) -> torch.Tensor:
    """The plain version of K4: (4, T, n_fft) f32 -> (T, C_out, n_mels)
    f32, with the kernel's constants and arithmetic, as GEMMs in float32."""
    feature_channels(feature_set)  # raises on an unknown set
    c_re, c_im, fb, fb_norm, lag_re, lag_im = spatial_constants(
        frames.shape[2], n_mels, sample_rate, frames.device
    )
    re = frames @ c_re  # (4, T, n_bins)
    im = frames @ c_im
    power = re * re + im * im
    planes = [10.0 * torch.log10(torch.clamp_min(power @ fb, amin))]
    # channels are picked by stacking, not by a list index, which torch
    # would upload from the host on every call
    if feature_set == "mel_iv":
        energy = (power[_ACN_W] + (power[_ACN_X] + power[_ACN_Y] + power[_ACN_Z]) / 3.0
                  ) / 2.0 + eps
        xyz = (_ACN_X, _ACN_Y, _ACN_Z)
        intensity = (re[_ACN_W] * torch.stack([re[c] for c in xyz])
                     + im[_ACN_W] * torch.stack([im[c] for c in xyz]))  # (3, T, n_bins)
        planes.append((intensity * (1.0 / energy)) @ fb_norm)
    elif feature_set == "mel_gcc":
        re_i, im_i = (torch.stack([x[a] for a, _ in _PAIRS]) for x in (re, im))
        re_j, im_j = (torch.stack([x[b] for _, b in _PAIRS]) for x in (re, im))
        cr = re_i * re_j + im_i * im_j  # conj(S_i) S_j, (6, T, n_bins)
        ci = re_i * im_j - im_i * re_j
        inv = torch.rsqrt(cr * cr + ci * ci + eps * eps)
        planes.append((cr * inv) @ lag_re + (ci * inv) @ lag_im)
    out = torch.cat(planes)[..., :n_mels]  # (C_out, T, n_mels)
    return out.transpose(0, 1).contiguous()


def _check_frames(frames: torch.Tensor) -> None:
    if frames.dtype != torch.float32:
        raise TypeError(f"K4 takes float32 frames, got {frames.dtype}")
    if frames.dim() != 3 or frames.shape[0] != 4:
        raise ValueError(
            f"K4 takes (4, T, n_fft) frames of 4 FOA channels, got {tuple(frames.shape)}"
        )
    if not frames.is_contiguous():
        raise ValueError("K4 takes contiguous frames")
    if frames.shape[2] % _DEPTH_TILE:
        raise ValueError(f"K4 needs n_fft divisible by {_DEPTH_TILE}, got {frames.shape[2]}")


@functools.cache
def _kernel():
    from seld_tpu_torch.ops._build import load_library

    fn = load_library("spatial_kernel").seld_spatial_features
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def spatial_features(frames: torch.Tensor, feature_set: str, n_mels: int = 64,
                     sample_rate: int = 24_000, amin: float = 1e-10,
                     eps: float = 1e-8) -> torch.Tensor:
    """(4, T, n_fft) float32 contiguous STFT frames of the 4 FOA channels
    -> (T, C_out, n_mels) float32 features, C_out 4 ("mel"), 7
    ("mel_iv") or 10 ("mel_gcc").

    A CUDA tensor goes through kernel K4 on the current stream, one launch
    per MAX_LAUNCH_FRAMES frames (every launch adds one to
    `spatial_features.launches`); a CPU tensor goes through
    `spatial_features_reference`. Anything else raises."""
    c_out = feature_channels(feature_set)
    _check_frames(frames)
    if frames.device.type == "cpu":
        return spatial_features_reference(frames, feature_set, n_mels, sample_rate,
                                          amin, eps)
    if frames.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, got {frames.device}")
    if n_mels > KERNEL_MELS:
        raise ValueError(f"K4 computes at most {KERNEL_MELS} mels, got {n_mels}")
    if frames.data_ptr() % 16:
        raise ValueError("K4 needs 16-byte aligned frames")
    _, t, n_fft = frames.shape
    consts = spatial_constants(n_fft, n_mels, sample_rate, frames.device)
    out = torch.empty((t, c_out, n_mels), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        for start in range(0, t, MAX_LAUNCH_FRAMES):
            n = min(MAX_LAUNCH_FRAMES, t - start)
            rc = _kernel()(
                FEATURE_SETS[feature_set], frames[:, start].data_ptr(), t * n_fft,
                *(c.data_ptr() for c in consts), out[start].data_ptr(), n, n_fft,
                consts[0].shape[1], n_mels, amin, eps, stream,
            )
            if rc != 0:
                raise RuntimeError(f"K4 launch failed with CUDA error {rc}")
            spatial_features.launches += 1
    return out


spatial_features.launches = 0
