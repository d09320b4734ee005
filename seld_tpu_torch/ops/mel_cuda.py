"""Kernel K1: STFT frames -> log-mel dB (CUDA C++, csrc/mel_kernel.cu).

Replaces seld_tpu/ops/mel_pallas.py::log_mel_frames_pallas. The kernel
computes, per frame, the Hann-windowed real FFT as a half-length complex
FFT in registers (one warp per frame), the power spectrum, its sparse
mel-filterbank sums and 10*log10(max(mel, amin)), keeping the spectrum
on chip, and reads the frames in place through their strides.
`fft_mel_plan` builds the tables it reads. The JAX package computes every
n_fft, so two more kernels in the same source take the others, and
`kernel_path` routes each n_fft to one of the three:

  "fft"   n_fft in KERNEL_N_FFT: the register FFT above;
  "mixed" an even n_fft whose half M = n_fft / 2 has no prime factor above
          7, 64 <= n_fft <= 4096: the same function with a mixed-radix
          Stockham FFT of M points in the warp's shared memory
          (csrc/mixed_fft.cuh, tables from `mixed_fft_plan`);
  "dft"   every other n_fft (odd, or a half with a larger prime factor):
          the windowed DFT as tiles of float32 products against bases
          whose depth is padded to a multiple of 16 (`dft_kernel_constants`).

Each kernel reads the frames in place and has its own launch counter.
`log_mel_frames` launches them for CUDA tensors and raises if a launch
fails; for CPU tensors, and only for those, it runs
`log_mel_frames_reference`, the same function as three PyTorch GEMMs, on
blocks of CPU_BLOCK_FRAMES frames (`in_frame_blocks`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from seld_tpu_torch.features.mel import hann_window, mel_filterbank
from seld_tpu_torch.ops.counters import bump

KERNEL_MELS = 64  # the kernel's largest n_mels (K4's filterbank width)
KERNEL_N_FFT = (512, 960, 1024, 2048)  # n_fft = 64 R, R in (8, 15, 16, 32)
# A CPU GEMM's row depends on the row count it was called with; the plain
# versions run on the CPU in blocks of this many frames, the last one
# zero-padded, so that a frame's features do not depend on how many frames
# came with it (streaming's bit-equality with the whole clip)
CPU_BLOCK_FRAMES = 64
MIXED_N_FFT_RANGE = (64, 4096)  # its n_fft: M = n_fft / 2 from 32 (GCC's 64 lags) to 2048
_WARP = 32  # lanes of a warp: the kernel's cross-lane FFT length
_BIN_TILE = 64  # dft_mel_constants pads n_bins to a multiple of it
DFT_DEPTH_TILE = 16  # the DFT kernel's depth step: its bases' rows are padded to it


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


def pad_depth(n_fft: int) -> int:
    """n_fft rounded up to the DFT kernels' depth tile."""
    return -(-n_fft // DFT_DEPTH_TILE) * DFT_DEPTH_TILE


def pad_rows(basis: torch.Tensor, rows: int) -> torch.Tensor:
    """basis (n, cols) with zero rows appended up to `rows`."""
    return torch.cat([basis, basis.new_zeros((rows - basis.shape[0], basis.shape[1]))])


@functools.lru_cache(maxsize=8)
def dft_kernel_constants(n_fft: int, n_mels: int, sample_rate: int, f_min: float,
                         f_max: float | None, device: torch.device):
    """(C_re, C_im, FB) of the general-n_fft kernel on `device`: those of
    dft_mel_constants with the bases' rows zero-padded to pad_depth(n_fft),
    built once per arguments. Callers must not write to them."""
    c_re, c_im, fb = dft_mel_constants(n_fft, n_mels, sample_rate, f_min, f_max, device)
    rows = pad_depth(n_fft)
    return pad_rows(c_re, rows), pad_rows(c_im, rows), fb


class FftMelPlan(NamedTuple):
    """The tables K1's kernel reads, float64 rounded once to float32.
    With M = n_fft / 2 = 32 R, complex values as trailing (re, im) pairs:

    window:         (n_fft,) periodic Hann window
    radix:          (16, 2) the per-lane R-point DFT's constants, W_p^j =
                    exp(-2 pi i j / p): W_R^j for j < R / 2 (R a power of
                    two), or W_3^1, W_5^1, W_5^2 (R = 15). Always on the
                    CPU: the kernel takes it by value.
    lane_twiddles:  (R, 32, 2) W_M^(lane * k2) at [k2, lane]
    warp_twiddles:  (4, 32, 2) stage s of the cross-lane radix-2 FFT (half
                    width h = 16 >> s): W_2h^(lane mod h) where lane & h,
                    else 1
    split_twiddles: (R, 32, 2) -(i/2) W_n_fft^k at k = r + R bitrev5(lane),
                    [r, lane]: the real split of the bin lane holds in r
    bands:          (3, n_mels) int32 first bin, bin count and offset into
                    `weights` of each mel band
    weights:        (nnz,) float32 each band's filterbank weights, packed
    """

    window: torch.Tensor
    radix: torch.Tensor
    lane_twiddles: torch.Tensor
    warp_twiddles: torch.Tensor
    split_twiddles: torch.Tensor
    bands: torch.Tensor
    weights: torch.Tensor


def bit_reverse5(v: np.ndarray) -> np.ndarray:
    """The 5-bit reversal of each entry (0..31)."""
    return np.array([int(f"{int(x):05b}"[::-1], 2) for x in np.ravel(v)]).reshape(np.shape(v))


def _unit(num, den) -> np.ndarray:
    """exp(-2 pi i num / den) in float64, num reduced mod den."""
    return np.exp(-2j * np.pi * (np.asarray(num) % den) / den)


def _pairs(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def check_kernel_shape(n_fft: int, n_mels: int) -> None:
    """Raise ValueError for an n_fft or n_mels the CUDA kernels do not take:
    any n_fft >= 1 (one of the three kernels, by `kernel_path`), 1 to
    KERNEL_MELS mels."""
    if n_fft < 1:
        raise ValueError(f"K1's CUDA kernel takes n_fft >= 1, got {n_fft}")
    if not 1 <= n_mels <= KERNEL_MELS:
        raise ValueError(f"K1's CUDA kernel computes 1 to {KERNEL_MELS} mels, got {n_mels}")


@functools.lru_cache(maxsize=8)
def fft_mel_plan(n_fft: int, n_mels: int, sample_rate: int, f_min: float,
                 f_max: float | None, device: torch.device) -> FftMelPlan:
    """K1's FFT tables for one (n_fft, n_mels, filterbank) on `device`,
    built once per arguments. Callers must not write to them."""
    check_kernel_shape(n_fft, n_mels)
    if n_fft not in KERNEL_N_FFT:
        raise ValueError(f"K1's FFT kernel takes n_fft in {KERNEL_N_FFT}, got {n_fft}")
    m = n_fft // 2
    r = m // _WARP
    lanes = np.arange(_WARP)

    radix = np.zeros(16, np.complex128)
    if r == 15:
        radix[:3] = [_unit(1, 3), _unit(1, 5), _unit(2, 5)]
    else:
        radix[:r // 2] = _unit(np.arange(r // 2), r)
    lane_tw = _unit(np.arange(r)[:, None] * lanes[None, :], m)
    warp_tw = np.ones((4, _WARP), np.complex128)
    for s in range(4):
        h = 16 >> s
        upper = (lanes & h) != 0
        warp_tw[s, upper] = _unit(lanes[upper] % h, 2 * h)
    k = np.arange(r)[:, None] + r * bit_reverse5(lanes)[None, :]
    split_tw = -0.5j * _unit(k, n_fft)

    bands, weights = packed_bands(m + 1, n_mels, sample_rate, f_min, f_max)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return FftMelPlan(
        window=dev(hann_window(n_fft)),
        radix=torch.from_numpy(_pairs(radix)),
        lane_twiddles=dev(_pairs(lane_tw)),
        warp_twiddles=dev(_pairs(warp_tw)),
        split_twiddles=dev(_pairs(split_tw)),
        bands=dev(bands),
        weights=dev(weights),
    )


def mixed_radices(m: int) -> tuple[int, ...] | None:
    """The mixed-radix kernel's passes for an M-point FFT, largest radix
    first (8s, then a 4 or a 2 for the rest of the power of two, then 7s,
    5s and 3s), or None when M has a prime factor above 7."""
    twos = 0
    while m % 2 == 0:
        m //= 2
        twos += 1
    radices = [8] * (twos // 3) + {0: [], 1: [2], 2: [4]}[twos % 3]
    for p in (7, 5, 3):
        while m % p == 0:
            m //= p
            radices.append(p)
    return tuple(sorted(radices, reverse=True)) if m == 1 else None


def kernel_path(n_fft: int) -> str:
    """Which of K1's and K4's CUDA kernels computes this n_fft: "fft" (the
    register FFT, KERNEL_N_FFT), "mixed" (the mixed-radix FFT: even n_fft
    in MIXED_N_FFT_RANGE whose half has no prime factor above 7) or "dft"
    (the DFT tiles: every other n_fft >= 1)."""
    if n_fft in KERNEL_N_FFT:
        return "fft"
    lo, hi = MIXED_N_FFT_RANGE
    if n_fft % 2 == 0 and lo <= n_fft <= hi and mixed_radices(n_fft // 2):
        return "mixed"
    return "dft"


class MixedFftPlan(NamedTuple):
    """The tables of K1's mixed-radix kernel, float64 rounded once to
    float32. With M = n_fft / 2, complex values as trailing (re, im):

    window:         (n_fft,) periodic Hann window
    radices:        (n_pass,) int32 the Stockham passes' radices, in order
                    (always on the CPU: the kernel takes them by value)
    consts:         (8, 2) the butterflies' constants W_p^j = exp(-2 pi i j
                    / p): W_3^1, W_5^1, W_5^2, W_7^1, W_7^2, W_7^3, W_8^1, 0
                    (on the CPU, by value)
    twiddles:       (M, 2) W_M^j, j < M: every pass's twiddle is one entry
    split_twiddles: (M, 2) -(i/2) W_n_fft^k, k < M: the real split of bin k
    bands, weights: as FftMelPlan's
    """

    window: torch.Tensor
    radices: torch.Tensor
    consts: torch.Tensor
    twiddles: torch.Tensor
    split_twiddles: torch.Tensor
    bands: torch.Tensor
    weights: torch.Tensor


def packed_bands(n_freqs: int, n_mels: int, sample_rate: int, f_min: float,
                 f_max: float | None) -> tuple[np.ndarray, np.ndarray]:
    """The mel filterbank packed per band: (3, n_mels) int32 first bin, bin
    count and offset into the weights, and the (nnz,) float32 weights."""
    fb = mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)
    bands = np.zeros((3, n_mels), np.int32)
    weights = []
    offset = 0
    for band in range(n_mels):
        nz = np.flatnonzero(fb[:, band])
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        bands[:, band] = first, count, offset
        weights.append(fb[first:first + count, band])
        offset += count
    return bands, np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=8)
def mixed_fft_plan(n_fft: int, n_mels: int, sample_rate: int, f_min: float,
                   f_max: float | None, device: torch.device) -> MixedFftPlan:
    """K1's mixed-radix tables for one (n_fft, n_mels, filterbank) on
    `device`, built once per arguments. Callers must not write to them."""
    check_kernel_shape(n_fft, n_mels)
    if kernel_path(n_fft) != "mixed":
        lo, hi = MIXED_N_FFT_RANGE
        raise ValueError(f"K1's mixed-radix kernel takes an even n_fft from {lo} to {hi} whose "
                         f"half has no prime factor above 7, got {n_fft}")
    m = n_fft // 2
    consts = np.zeros(8, np.complex128)
    consts[:7] = [_unit(1, 3), _unit(1, 5), _unit(2, 5), _unit(1, 7), _unit(2, 7),
                  _unit(3, 7), _unit(1, 8)]
    bands, weights = packed_bands(m + 1, n_mels, sample_rate, f_min, f_max)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return MixedFftPlan(
        window=dev(hann_window(n_fft)),
        radices=torch.tensor(mixed_radices(m), dtype=torch.int32),
        consts=torch.from_numpy(_pairs(consts)),
        twiddles=dev(_pairs(_unit(np.arange(m), m))),
        split_twiddles=dev(_pairs(-0.5j * _unit(np.arange(m), n_fft))),
        bands=dev(bands),
        weights=dev(weights),
    )


def log_mel_frames_reference(frames: torch.Tensor, n_mels: int = 64,
                             sample_rate: int = 24_000, f_min: float = 0.0,
                             f_max: float | None = None,
                             amin: float = 1e-10) -> torch.Tensor:
    """The plain version of K1: (N, n_fft) f32 -> (N, n_mels) f32 dB,
    the windowed DFT and the filterbank as GEMMs in float32."""
    c_re, c_im, fb = dft_mel_constants(
        frames.shape[1], n_mels, sample_rate, f_min, f_max, frames.device
    )
    re = frames @ c_re
    im = frames @ c_im
    mel = (re * re + im * im) @ fb
    return (10.0 * torch.log10(torch.clamp_min(mel, amin)))[:, :n_mels].contiguous()


def in_frame_blocks(fn, frames: torch.Tensor, axis: int, out_axis: int) -> torch.Tensor:
    """fn over blocks of CPU_BLOCK_FRAMES frames of `frames` along `axis`,
    the last block zero-padded; the outputs concatenated along `out_axis`
    and cut to the frame count."""
    n = frames.shape[axis]
    padded = -(-n // CPU_BLOCK_FRAMES) * CPU_BLOCK_FRAMES
    shape = list(frames.shape)
    shape[axis] = padded - n
    frames = torch.cat([frames, frames.new_zeros(shape)], dim=axis)
    out = torch.cat([fn(block.contiguous())
                     for block in frames.split(CPU_BLOCK_FRAMES, dim=axis)],
                    dim=out_axis)
    return out.narrow(out_axis, 0, n)


def _check_frames(frames: torch.Tensor, n_fft: int) -> None:
    if frames.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 frames, got {frames.dtype}")
    if frames.dim() not in (2, 3) or frames.shape[-1] != n_fft:
        raise ValueError(
            f"K1 takes (N, {n_fft}) or (C, T, {n_fft}) frames, got {tuple(frames.shape)}"
        )
    if frames.stride(-1) != 1:
        raise ValueError(
            f"K1 reads frames whose last axis has unit stride, got stride {frames.stride(-1)}"
        )


# argument types of the C entries of csrc/mel_kernel.cu
_ARGTYPES = {
    "seld_log_mel_frames": (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]),
    "seld_log_mel_frames_mixed": (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int]
        + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]),
    "seld_log_mel_frames_dft": (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]),
}


@functools.cache
def _entry(name: str):
    """The C entry `name` of csrc/mel_kernel.cu, with its argument types."""
    from seld_tpu_torch.ops._build import load_library

    fn = getattr(load_library("mel_kernel"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def log_mel_frames(frames: torch.Tensor, n_fft: int = 960, n_mels: int = 64,
                   sample_rate: int = 24_000, f_min: float = 0.0,
                   f_max: float | None = None,
                   amin: float = 1e-10) -> torch.Tensor:
    """(N, n_fft) or (C, T, n_fft) float32 STFT frames -> (N, n_mels) or
    (C, T, n_mels) float32 log-mel dB.

    The frames may be any view whose last axis has unit stride, such as
    `features.mel.frame_signal`'s view of the padded waveform: a CUDA
    tensor is read in place by kernel K1, in one launch on the current
    stream, up to KERNEL_MELS mels, of the kernel `kernel_path(n_fft)`
    names (`launch`); a CPU tensor goes through `log_mel_frames_reference`,
    in blocks of CPU_BLOCK_FRAMES frames. Anything else raises."""
    _check_frames(frames, n_fft)
    if frames.device.type == "cpu":
        return in_frame_blocks(
            lambda block: log_mel_frames_reference(block, n_mels, sample_rate, f_min,
                                                   f_max, amin),
            frames.reshape(-1, n_fft), 0, 0,
        ).reshape(*frames.shape[:-1], n_mels)
    return launch(kernel_path(n_fft), frames, n_fft, n_mels, sample_rate, f_min, f_max, amin)


def launch(path: str, frames: torch.Tensor, n_fft: int = 960, n_mels: int = 64,
           sample_rate: int = 24_000, f_min: float = 0.0, f_max: float | None = None,
           amin: float = 1e-10) -> torch.Tensor:
    """K1's kernel `path` ("fft", "mixed" or "dft") on CUDA frames, as
    `log_mel_frames` launches the one kernel_path(n_fft) names; each launch
    adds one to its counter: `log_mel_frames.launches`, `.mixed_launches`
    or `.dft_launches`. The DFT tiles take any n_fft, the other two only
    their own (ValueError). A failed launch raises RuntimeError."""
    _check_frames(frames, n_fft)
    if frames.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {frames.device}")
    check_kernel_shape(n_fft, n_mels)
    lead = frames.shape[:-1]
    out = torch.empty((*lead, n_mels), dtype=torch.float32, device=frames.device)
    if out.numel() == 0:
        return out
    if frames.dim() == 2:
        n_channels, n_frames, channel_stride, frame_stride = 1, lead[0], 0, frames.stride(0)
    else:
        (n_channels, n_frames), (channel_stride, frame_stride) = lead, frames.stride()[:2]
    head = (frames.data_ptr(), channel_stride, frame_stride, n_channels, n_frames, n_fft)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        if path == "fft":
            plan = fft_mel_plan(n_fft, n_mels, sample_rate, f_min, f_max, frames.device)
            rc = _entry("seld_log_mel_frames")(
                *head, plan.window.data_ptr(), plan.lane_twiddles.data_ptr(),
                plan.warp_twiddles.data_ptr(), plan.split_twiddles.data_ptr(),
                plan.radix.data_ptr(), plan.bands.data_ptr(), plan.weights.data_ptr(),
                n_mels, amin, out.data_ptr(), stream,
            )
            counter = "launches"
        elif path == "mixed":
            plan = mixed_fft_plan(n_fft, n_mels, sample_rate, f_min, f_max, frames.device)
            rc = _entry("seld_log_mel_frames_mixed")(
                *head, plan.window.data_ptr(), plan.twiddles.data_ptr(),
                plan.split_twiddles.data_ptr(), plan.radices.data_ptr(), plan.radices.numel(),
                plan.consts.data_ptr(), plan.bands.data_ptr(), plan.weights.data_ptr(),
                n_mels, amin, out.data_ptr(), stream,
            )
            counter = "mixed_launches"
        elif path == "dft":
            c_re, c_im, fb = dft_kernel_constants(n_fft, n_mels, sample_rate, f_min, f_max,
                                                  frames.device)
            rc = _entry("seld_log_mel_frames_dft")(
                *head, c_re.shape[0], c_re.data_ptr(), c_im.data_ptr(), fb.data_ptr(),
                c_re.shape[1], n_mels, amin, out.data_ptr(), stream,
            )
            counter = "dft_launches"
        else:
            raise ValueError(f"K1's kernels are 'fft', 'mixed' and 'dft', got {path!r}")
    if rc != 0:
        raise RuntimeError(f"K1's {path} kernel failed to launch: CUDA error {rc}")
    bump(log_mel_frames, counter)
    return out


log_mel_frames.launches = 0
log_mel_frames.mixed_launches = 0
log_mel_frames.dft_launches = 0
