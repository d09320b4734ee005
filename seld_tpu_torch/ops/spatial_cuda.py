"""Kernel K4: 4-channel STFT frames -> spatial feature stack (CUDA C++,
csrc/spatial_kernel.cu).

Replaces seld_tpu/ops/spatial_pallas.py::spatial_features_pallas. For
each frame of the four FOA channels (ACN order W, Y, Z, X) the kernel
computes the Hann-windowed real FFT of each channel in registers (K1's
stage, csrc/warp_fft.cuh) and, without writing a spectrum to device
memory, 4 log-mel planes and either 3 energy-normalised intensity-vector
planes on the column-normalised filterbank ("mel_iv") or 6
PHAT-normalised cross-spectra taken to n_mels centred lags by a pruned
inverse FFT ("mel_gcc"). It computes what the TPU kernel computes, not the
rFFT oracle of seld_tpu_torch.features.spatial: GCC normalises with
rsqrt(cr^2 + ci^2 + eps^2), and the lags read only the real parts of the
cross-spectrum's bins 0 and n_fft / 2.

`spatial_plan` builds the tables it reads. Two more kernels in the same
source take the other n_fft, routed as K1 routes them
(`mel_cuda.kernel_path`): "mixed", the same stages on K1's mixed-radix
Stockham FFT in shared memory (csrc/mixed_fft.cuh; tables from
`mixed_spatial_plan`), the GCC planes through a full inverse FFT of the
same plan; "dft", the windowed DFT as tiles of float32 products against
`spatial_constants` with the bases' depth padded to a multiple of 16.
Each kernel has its own launch counter. `spatial_features` launches the
one its n_fft takes for CUDA tensors, once per call, reading the frames in
place through their strides, and raises if the launch fails; for CPU
tensors, and only for those, it runs `spatial_features_reference`, the
same function as float32 GEMMs with the TPU kernel's padded constants.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from seld_tpu_torch.features.mel import mel_filterbank
from seld_tpu_torch.features.spatial import _ACN_W, _ACN_X, _ACN_Y, _ACN_Z, feature_channels
from seld_tpu_torch.ops.counters import bump
from seld_tpu_torch.ops.mel_cuda import (
    _WARP,
    KERNEL_MELS,
    KERNEL_N_FFT,
    FftMelPlan,
    MixedFftPlan,
    _pairs,
    _unit,
    dft_mel_constants,
    fft_mel_plan,
    in_frame_blocks,
    kernel_path,
    mixed_fft_plan,
    pad_depth,
    pad_rows,
)

FEATURE_SETS = {"mel": 0, "mel_iv": 1, "mel_gcc": 2}
_PAIRS = list(itertools.combinations(range(4), 2))


def column_normalised(fb: np.ndarray) -> np.ndarray:
    """The filterbank with each column divided by max(its sum, 1e-8):
    FB_norm, as seld_tpu/ops/spatial_pallas.py::_constants forms it."""
    return fb / np.maximum(fb.sum(axis=0, keepdims=True), 1e-8)


@functools.lru_cache(maxsize=8)
def spatial_constants(n_fft: int, n_mels: int, sample_rate: int, device: torch.device):
    """(C_re, C_im, FB, FB_norm, LAG_re, LAG_im) float32 on `device`,
    built once per arguments; callers must not write to them.

    C_re, C_im and FB are those of K1's plain version
    (mel_cuda.dft_mel_constants): the DFT bases with the n_fft//2 + 1 bins
    zero-padded to a multiple of 64, and the (n_bins, 64) mel filterbank.
    FB_norm is FB with its columns divided by max(column sum, 1e-8);
    LAG_re/LAG_im, also (n_bins, 64), are the inverse one-sided DFT onto
    lags l - n_mels//2 (weights 1 at bins 0 and n_fft/2, else 2, over
    n_fft). All are zero outside the real bins and the n_mels columns."""
    c_re, c_im, fb = dft_mel_constants(n_fft, n_mels, sample_rate, 0.0, None, device)
    fb_np = fb.cpu().numpy()
    fb_norm = column_normalised(fb_np)

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


class SpatialPlan(NamedTuple):
    """The tables K4's kernel reads, float64 rounded once to float32.

    mel:          K1's plan (mel_cuda.FftMelPlan) for this n_fft, n_mels
                  and sample rate: the window, the forward FFT's twiddles
                  and the filterbank packed per band
    norm_weights: (nnz,) float32 the column-normalised filterbank FB_norm
                  packed with FB's bands (the same bins; other weights)
    lag_twiddles: (R, 32, 2) the GCC inverse's pruned lane sum: (2 /
                  n_fft) exp(2 pi i k2 n / M) at [k2, lane], M = n_fft / 2
                  = 32 R, n = lane for lanes 0-15 and M - 32 + lane for
                  lanes 16-31 (the complex samples that hold the lags)
    """

    mel: FftMelPlan
    norm_weights: torch.Tensor
    lag_twiddles: torch.Tensor


def check_kernel_shape(n_fft: int, n_mels: int) -> None:
    """Raise ValueError for an n_fft or n_mels the CUDA kernels do not take:
    any n_fft >= 1 (one of the three kernels, by `kernel_path`), 1 to
    KERNEL_MELS mels."""
    if n_fft < 1:
        raise ValueError(f"K4's CUDA kernel takes n_fft >= 1, got {n_fft}")
    if not 1 <= n_mels <= KERNEL_MELS:
        raise ValueError(f"K4 computes at most {KERNEL_MELS} mels (and at least 1), got {n_mels}")


@functools.lru_cache(maxsize=8)
def spatial_plan(n_fft: int, n_mels: int, sample_rate: int,
                 device: torch.device) -> SpatialPlan:
    """K4's FFT tables for one (n_fft, n_mels, sample rate) on `device`,
    built once per arguments. Callers must not write to them."""
    check_kernel_shape(n_fft, n_mels)
    if n_fft not in KERNEL_N_FFT:
        raise ValueError(f"K4's FFT kernel takes n_fft in {KERNEL_N_FFT}, got {n_fft}")
    mel = fft_mel_plan(n_fft, n_mels, sample_rate, 0.0, None, device)
    m = n_fft // 2
    r = m // _WARP
    norm = packed_norm_weights(mel.bands, n_fft, n_mels, sample_rate)
    lanes = np.arange(_WARP)
    n = np.where(lanes < _WARP // 2, lanes, m - _WARP + lanes)
    lag_tw = (2.0 / n_fft) * np.conj(_unit(np.arange(r)[:, None] * n[None, :], m))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return SpatialPlan(mel=mel, norm_weights=dev(norm), lag_twiddles=dev(_pairs(lag_tw)))


def packed_norm_weights(bands: torch.Tensor, n_fft: int, n_mels: int,
                        sample_rate: int) -> np.ndarray:
    """(nnz,) float32 the column-normalised filterbank FB_norm packed with
    FB's bands (first bin, bin count per band): the same bins, other weights."""
    fb_norm = column_normalised(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate))
    first, count, _ = bands.cpu().numpy()
    return np.concatenate([fb_norm[f:f + c, band]
                           for band, (f, c) in enumerate(zip(first, count))]).astype(np.float32)


class MixedSpatialPlan(NamedTuple):
    """The tables of K4's mixed-radix kernel: K1's mixed-radix plan
    (mel_cuda.MixedFftPlan) for this n_fft, n_mels and sample rate, FB_norm
    packed with its bands (as SpatialPlan's), and the GCC inverse's scale
    2 / n_fft (float64 rounded once)."""

    mel: MixedFftPlan
    norm_weights: torch.Tensor
    scale: float


@functools.lru_cache(maxsize=8)
def mixed_spatial_plan(n_fft: int, n_mels: int, sample_rate: int,
                       device: torch.device) -> MixedSpatialPlan:
    """K4's mixed-radix tables for one (n_fft, n_mels, sample rate) on
    `device`, built once per arguments. Callers must not write to them."""
    check_kernel_shape(n_fft, n_mels)
    mel = mixed_fft_plan(n_fft, n_mels, sample_rate, 0.0, None, device)
    norm = packed_norm_weights(mel.bands, n_fft, n_mels, sample_rate)
    return MixedSpatialPlan(mel=mel, norm_weights=torch.from_numpy(norm).to(device),
                            scale=float(np.float32(2.0 / n_fft)))


def _check_frames(frames: torch.Tensor) -> None:
    if frames.dtype != torch.float32:
        raise TypeError(f"K4 takes float32 frames, got {frames.dtype}")
    if frames.dim() != 3 or frames.shape[0] != 4:
        raise ValueError(
            f"K4 takes (4, T, n_fft) frames of 4 FOA channels, got {tuple(frames.shape)}"
        )
    if frames.stride(2) != 1:
        raise ValueError(
            f"K4 reads frames whose last axis has unit stride, got stride {frames.stride(2)}"
        )


@functools.lru_cache(maxsize=8)
def dft_kernel_constants(n_fft: int, n_mels: int, sample_rate: int, device: torch.device):
    """spatial_constants with the DFT bases' rows zero-padded to
    pad_depth(n_fft): what the general-n_fft kernel reads. Built once per
    arguments; callers must not write to them."""
    c_re, c_im, *rest = spatial_constants(n_fft, n_mels, sample_rate, device)
    rows = pad_depth(n_fft)
    return (pad_rows(c_re, rows), pad_rows(c_im, rows), *rest)


# argument types of the C entries of csrc/spatial_kernel.cu
_HEAD = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
_ARGTYPES = {
    "seld_spatial_features": (
        _HEAD + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
        + [ctypes.c_int, ctypes.c_float, ctypes.c_float] + [ctypes.c_void_p] * 2),
    "seld_spatial_features_mixed": (
        _HEAD + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_float] * 3
        + [ctypes.c_void_p] * 2),
    "seld_spatial_features_dft": (
        _HEAD + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float]
        + [ctypes.c_void_p] * 2),
}


@functools.cache
def _entry(name: str):
    """The C entry `name` of csrc/spatial_kernel.cu, with its argument types."""
    from seld_tpu_torch.ops._build import load_library

    fn = getattr(load_library("spatial_kernel"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def spatial_features(frames: torch.Tensor, feature_set: str, n_mels: int = 64,
                     sample_rate: int = 24_000, amin: float = 1e-10,
                     eps: float = 1e-8) -> torch.Tensor:
    """(4, T, n_fft) float32 STFT frames of the 4 FOA channels -> (T,
    C_out, n_mels) float32 features, C_out 4 ("mel"), 7 ("mel_iv") or 10
    ("mel_gcc").

    The frames may be any view whose last axis has unit stride, such as
    `features.mel.frame_signal`'s view of the padded waveform: a CUDA
    tensor is read in place by kernel K4, in one launch on the current
    stream, up to KERNEL_MELS mels, of the kernel `kernel_path(n_fft)`
    names (`launch`); a CPU tensor goes through `spatial_features_reference`,
    in blocks of mel_cuda.CPU_BLOCK_FRAMES frames. Anything else raises."""
    feature_channels(feature_set)  # raises on an unknown set
    _check_frames(frames)
    if frames.device.type == "cpu":
        return in_frame_blocks(
            lambda block: spatial_features_reference(block, feature_set, n_mels,
                                                     sample_rate, amin, eps),
            frames, 1, 0)
    return launch(kernel_path(frames.shape[2]), frames, feature_set, n_mels, sample_rate,
                  amin, eps)


def launch(path: str, frames: torch.Tensor, feature_set: str, n_mels: int = 64,
           sample_rate: int = 24_000, amin: float = 1e-10,
           eps: float = 1e-8) -> torch.Tensor:
    """K4's kernel `path` ("fft", "mixed" or "dft") on CUDA frames, as
    `spatial_features` launches the one kernel_path(n_fft) names; each
    launch adds one to its counter: `spatial_features.launches`,
    `.mixed_launches` or `.dft_launches`. The DFT tiles take any n_fft, the
    other two only their own (ValueError). A failed launch raises
    RuntimeError."""
    c_out = feature_channels(feature_set)
    _check_frames(frames)
    if frames.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, got {frames.device}")
    _, t, n_fft = frames.shape
    check_kernel_shape(n_fft, n_mels)
    out = torch.empty((t, c_out, n_mels), dtype=torch.float32, device=frames.device)
    if t == 0:
        return out
    head = (FEATURE_SETS[feature_set], frames.data_ptr(), frames.stride(0), frames.stride(1),
            t, n_fft)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        if path == "fft":
            plan = spatial_plan(n_fft, n_mels, sample_rate, frames.device)
            mel = plan.mel
            rc = _entry("seld_spatial_features")(
                *head, mel.window.data_ptr(), mel.lane_twiddles.data_ptr(),
                mel.warp_twiddles.data_ptr(), mel.split_twiddles.data_ptr(),
                plan.lag_twiddles.data_ptr(), mel.radix.data_ptr(), mel.bands.data_ptr(),
                mel.weights.data_ptr(), plan.norm_weights.data_ptr(), n_mels, amin, eps,
                out.data_ptr(), stream,
            )
            counter = "launches"
        elif path == "mixed":
            plan = mixed_spatial_plan(n_fft, n_mels, sample_rate, frames.device)
            mel = plan.mel
            rc = _entry("seld_spatial_features_mixed")(
                *head, mel.window.data_ptr(), mel.twiddles.data_ptr(),
                mel.split_twiddles.data_ptr(), mel.radices.data_ptr(), mel.radices.numel(),
                mel.consts.data_ptr(), mel.bands.data_ptr(), mel.weights.data_ptr(),
                plan.norm_weights.data_ptr(), n_mels, amin, eps, plan.scale, out.data_ptr(),
                stream,
            )
            counter = "mixed_launches"
        elif path == "dft":
            c_re, c_im, fb, fb_norm, lag_re, lag_im = dft_kernel_constants(
                n_fft, n_mels, sample_rate, frames.device)
            rc = _entry("seld_spatial_features_dft")(
                *head, c_re.shape[0], c_re.data_ptr(), c_im.data_ptr(), fb.data_ptr(),
                fb_norm.data_ptr(), lag_re.data_ptr(), lag_im.data_ptr(), c_re.shape[1],
                n_mels, amin, eps, out.data_ptr(), stream,
            )
            counter = "dft_launches"
        else:
            raise ValueError(f"K4's kernels are 'fft', 'mixed' and 'dft', got {path!r}")
    if rc != 0:
        raise RuntimeError(f"K4's {path} kernel failed to launch: CUDA error {rc}")
    bump(spatial_features, counter)
    return out


spatial_features.launches = 0
spatial_features.mixed_launches = 0
spatial_features.dft_launches = 0
