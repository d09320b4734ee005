"""The port's log-mel front-end against seld_tpu's: kernel K1's plain
version (the float32 GEMMs its wrapper runs on the CPU) against the Pallas
kernel in interpret mode and the rFFT oracle; numpy emulations of the
CUDA kernels' stage orders, on the tables of `fft_mel_plan` (the register
FFT, at every n_fft it takes) and of `mixed_fft_plan` (the mixed-radix
Stockham FFT, at n_fft 1200, 600, 640, 882, 1764 and 1920), against
numpy's rFFT, the plain version, the Pallas kernel and the JAX rFFT
oracle; the routing of every n_fft to one of the three kernels; the
general-n_fft DFT kernel's emulation at n_fft 1202 and 17; the corpus entry point against
seld_tpu.data.corpus.compute_mel_features; the spatial feature sets
route to K4 (tests/test_torch_spatial.py holds K4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import FeatureConfig
from seld_tpu.data.corpus import compute_mel_features as jax_compute_mel_features
from seld_tpu.features import frame_signal, hann_window, log_mel_spectrogram, mel_filterbank
from seld_tpu.ops.mel_pallas import log_mel_frames_pallas
from seld_tpu_torch.config import FeatureConfig as PortFeatureConfig
from seld_tpu_torch.data.corpus import compute_mel_features
from seld_tpu_torch.features import mel as port_mel
from seld_tpu_torch.ops.mel_cuda import (
    KERNEL_N_FFT,
    MIXED_N_FFT_RANGE,
    FftMelPlan,
    bit_reverse5,
    check_kernel_shape,
    dft_kernel_constants,
    fft_mel_plan,
    kernel_path,
    log_mel_frames,
    log_mel_frames_reference,
    mixed_fft_plan,
    mixed_radices,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SR, NFFT, HOP, NMELS = 24_000, 960, 480, 64
# tests/test_pallas_kernels.py's bar for the fused mel kernel: a windowed
# DFT as float32 GEMMs against an rFFT differs by a few 1e-4 dB at most
DB_ATOL = 5e-3


@pytest.fixture(scope="module")
def frames():
    wave = np.random.default_rng(0).standard_normal(SR // 2).astype(np.float32)
    return wave, np.array(frame_signal(jnp.asarray(wave), NFFT, HOP))  # (26, 960)


def test_constants_match_jax():
    np.testing.assert_array_equal(port_mel.hann_window(NFFT), hann_window(NFFT))
    np.testing.assert_array_equal(
        port_mel.mel_filterbank(NFFT // 2 + 1, NMELS, SR),
        mel_filterbank(NFFT // 2 + 1, NMELS, SR),
    )


def test_frame_signal_matches_jax(frames):
    wave, want = frames
    got = port_mel.frame_signal(torch.from_numpy(wave), NFFT, HOP).numpy()
    np.testing.assert_array_equal(got, want)  # a pure copy of samples


def test_plain_k1_matches_pallas_and_oracle(frames):
    wave, fr = frames
    got = log_mel_frames(torch.from_numpy(fr)).numpy()
    pallas = np.asarray(log_mel_frames_pallas(jnp.asarray(fr), interpret=True))
    oracle = np.asarray(log_mel_spectrogram(jnp.asarray(wave))).T
    assert got.shape == pallas.shape == oracle.shape == (26, NMELS)
    np.testing.assert_allclose(got, pallas, atol=DB_ATOL)
    np.testing.assert_allclose(got, oracle, atol=DB_ATOL)


def test_port_log_mel_spectrogram_matches_jax(frames):
    wave, _ = frames
    got = port_mel.log_mel_spectrogram(torch.from_numpy(wave)).numpy()
    want = np.asarray(log_mel_spectrogram(jnp.asarray(wave)))
    # two float32 rFFT implementations: same bar as the kernel
    np.testing.assert_allclose(got, want, atol=DB_ATOL)


def test_plain_k1_non_tile_multiple():
    fr = np.random.default_rng(1).standard_normal((37, NFFT)).astype(np.float32)
    got = log_mel_frames(torch.from_numpy(fr)).numpy()
    want = np.asarray(log_mel_frames_pallas(jnp.asarray(fr), interpret=True))
    assert got.shape == (37, NMELS) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=DB_ATOL)


def test_plain_k1_silence_hits_amin():
    got = log_mel_frames(torch.zeros((8, NFFT))).numpy()
    np.testing.assert_allclose(got, -100.0, atol=1e-4)  # 10*log10(1e-10)


def test_compute_mel_features_matches_jax():
    wave = (0.1 * np.random.default_rng(2).standard_normal((4, SR))).astype(np.float32)
    want = jax_compute_mel_features(wave, FeatureConfig())
    got = compute_mel_features(wave, PortFeatureConfig(), device="cpu").numpy()
    assert got.shape == want.shape == (1 + SR // HOP, 4, NMELS)
    np.testing.assert_allclose(got, want, atol=DB_ATOL)


def test_spatial_feature_sets_name_their_kernel(monkeypatch):
    """mel_iv and mel_gcc go through K4's wrapper (its plain version on the
    CPU), never through K1."""
    from seld_tpu_torch.data import corpus as port_corpus

    calls = []
    real = port_corpus.spatial_features
    monkeypatch.setattr(port_corpus, "spatial_features",
                        lambda frames, fs, **kw: calls.append(fs) or real(frames, fs, **kw))
    monkeypatch.setattr(port_corpus, "log_mel_frames", None)  # K1 must not be reached
    for feature_set, channels in (("mel_iv", 7), ("mel_gcc", 10)):
        got = compute_mel_features(np.zeros((4, SR), np.float32),
                                   PortFeatureConfig(feature_set=feature_set), device="cpu")
        assert calls[-1] == feature_set and got.shape == (1 + SR // HOP, channels, NMELS)



# --- the CUDA kernel's arithmetic, stage by stage, in float32 numpy ------


def _complex(table) -> np.ndarray:
    a = table.numpy()
    return (a[..., 0] + 1j * a[..., 1]).astype(np.complex64)


def _dft3(a0, a1, a2, w):
    t, d = a1 + a2, a1 - a2
    m = a0 + w.real * t
    r = 1j * w.imag * d  # (a1 - a2) * (-i sin(2 pi / 3))
    return a0 + t, m + r, m - r


def _dft5(a, w1, w2):
    s1, d1 = a[1] + a[4], a[1] - a[4]
    s2, d2 = a[2] + a[3], a[2] - a[3]
    c1, c2, n1, n2 = w1.real, w2.real, -w1.imag, -w2.imag
    p1 = a[0] + c1 * s1 + c2 * s2
    p2 = a[0] + c2 * s1 + c1 * s2
    q1 = n1 * d1 + n2 * d2
    q2 = n2 * d1 - n1 * d2
    return [a[0] + (s1 + s2), p1 - 1j * q1, p2 - 1j * q2, p2 + 1j * q2, p1 + 1j * q1]


def _lane_dft(z: np.ndarray, radix: np.ndarray) -> np.ndarray:
    """The per-lane R-point DFT over the last axis, as the kernel runs it."""
    r = z.shape[-1]
    out = np.empty_like(z)
    if r == 15:  # prime-factor 3 x 5
        t = [_dft5([z[..., (5 * n1 + 3 * n2) % 15] for n2 in range(5)], radix[1], radix[2])
             for n1 in range(3)]
        for k2 in range(5):
            for k1, u in enumerate(_dft3(t[0][k2], t[1][k2], t[2][k2], radix[0])):
                out[..., (10 * k1 + 6 * k2) % 15] = u
        return out
    a = [z[..., j] for j in range(r)]
    h = r // 2
    while h:  # radix-2 decimation in frequency
        for b in range(0, r, 2 * h):
            for i in range(h):
                u, v = a[b + i], a[b + i + h]
                a[b + i] = u + v
                a[b + i + h] = (u - v) * radix[i * (r // (2 * h))] if i else u - v
        h //= 2
    bits = r.bit_length() - 1
    for k in range(r):
        out[..., k] = a[int(f"{k:0{bits}b}"[::-1], 2)]
    return out


def emulate_rfft(frames: np.ndarray, plan) -> np.ndarray:
    """(N, n_fft) float32 frames -> (N, n_fft/2 + 1) complex64 spectra
    through warp_fft.cuh's stages: the packing and window, the lane DFT,
    the lane twiddles, five cross-lane radix-2 stages and the real split."""
    n, n_fft = frames.shape
    m = n_fft // 2
    r = m // 32
    lanes = np.arange(32)
    xw = frames * plan.window.numpy()
    z = (xw[:, 0::2] + 1j * xw[:, 1::2]).astype(np.complex64)
    z = z.reshape(n, r, 32).transpose(0, 2, 1)  # [frame, lane, j]: sample pair lane + 32 j
    z = _lane_dft(z, _complex(plan.radix))
    z = z * _complex(plan.lane_twiddles).T
    warp = _complex(plan.warp_twiddles)
    for s in range(5):
        h = 16 >> s
        p = z[:, lanes ^ h]
        y = np.where(((lanes & h) != 0)[None, :, None], p - z, p + z)
        z = y * warp[s][:, None] if s < 4 else y
    k1 = bit_reverse5(lanes)
    partner = np.empty_like(z)
    partner[:, :, 0] = z[:, bit_reverse5((32 - k1) % 32), 0]
    for j in range(1, r):
        partner[:, :, j] = z[:, lanes ^ 31, r - j]
    b = np.conj(partner)
    x = np.float32(0.5) * (z + b) + _complex(plan.split_twiddles).T * (z - b)
    spec = np.empty((n, m + 1), np.complex64)
    spec[:, np.arange(r)[None, :] + r * k1[:, None]] = x
    spec[:, m] = z[:, 0, 0].real - z[:, 0, 0].imag
    return spec


def _dft4(a0, a1, a2, a3):
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, a1 - a3
    return [t0 + t2, t1 - 1j * t3, t0 - t2, t1 + 1j * t3]


def _butterfly(v: list, consts: np.ndarray) -> list:
    """The mixed-radix kernel's R-point DFT of v[0..R) (mixed_fft.cuh's
    dft / dft3 / dft4 / dft5 / dft7 / dft8), natural order in and out."""
    r = len(v)
    if r == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if r == 3:
        return list(_dft3(v[0], v[1], v[2], consts[0]))
    if r == 4:
        return _dft4(*v)
    if r == 5:
        return _dft5(v, consts[1], consts[2])
    if r == 8:
        e, o = _dft4(*v[0::2]), _dft4(*v[1::2])
        h = consts[6].real  # W_8^1 = (h, -h)
        o[1] = h * (o[1].real + o[1].imag) + 1j * h * (o[1].imag - o[1].real)
        o[2] = o[2].imag - 1j * o[2].real
        o[3] = h * (o[3].imag - o[3].real) - 1j * h * (o[3].real + o[3].imag)
        return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]
    assert r == 7
    s1, s2, s3 = (v[j] + v[7 - j] for j in (1, 2, 3))
    d1, d2, d3 = (v[j] - v[7 - j] for j in (1, 2, 3))
    (c1, c2, c3), (n1, n2, n3) = consts[3:6].real, -consts[3:6].imag
    p = [v[0] + c1 * s1 + c2 * s2 + c3 * s3, v[0] + c2 * s1 + c3 * s2 + c1 * s3,
         v[0] + c3 * s1 + c1 * s2 + c2 * s3]
    q = [n1 * d1 + n2 * d2 + n3 * d3, n2 * d1 - n3 * d2 - n1 * d3, n3 * d1 - n1 * d2 + n2 * d3]
    return ([v[0] + ((s1 + s2) + s3)] + [p[k] - 1j * q[k] for k in range(3)]
            + [p[k] + 1j * q[k] for k in (2, 1, 0)])


def emulate_stockham(z: np.ndarray, plan) -> np.ndarray:
    """(N, M) complex64 -> DFT_M over the last axis through mixed_fft.cuh's
    passes: per radix R of the plan, after passes whose radices multiply to
    ns, butterfly j reads j + r M / R, multiplies by W_M^(r (j mod ns) M /
    (ns R)) from the plan's table, and writes (j // ns) ns R + j mod ns +
    r ns."""
    m = z.shape[1]
    tw, consts = _complex(plan.twiddles), _complex(plan.consts)
    ns = 1
    for r in plan.radices.tolist():
        nb = m // r
        j = np.arange(nb)
        k = j % ns
        v = [z[:, j + i * nb] * (tw[i * k * (m // (ns * r))] if i and ns > 1 else 1)
             for i in range(r)]
        out = np.empty_like(z)
        for i, y in enumerate(_butterfly(v, consts)):
            out[:, (j // ns) * ns * r + k + i * ns] = y
        z = out
        ns *= r
    return z


def emulate_mixed_rfft(frames: np.ndarray, plan) -> np.ndarray:
    """(N, n_fft) float32 frames -> (N, n_fft/2 + 1) complex64 spectra
    through the mixed-radix stage: the packing and window, the Stockham
    passes, the real split with the partner bin M - k read back."""
    m = frames.shape[1] // 2
    xw = frames * plan.window.numpy()
    z = emulate_stockham((xw[:, 0::2] + 1j * xw[:, 1::2]).astype(np.complex64), plan)
    b = np.conj(z[:, (m - np.arange(m)) % m])
    spec = np.empty((frames.shape[0], m + 1), np.complex64)
    spec[:, :m] = np.float32(0.5) * (z + b) + _complex(plan.split_twiddles) * (z - b)
    spec[:, m] = z[:, 0].real - z[:, 0].imag
    return spec


def band_sums(values: np.ndarray, plan, weights=None) -> np.ndarray:
    """(N, n_fft/2 + 1) per-bin values -> (N, n_mels) sums over each
    band's packed bins, with the plan's filterbank weights or others
    packed alike."""
    first, count, offset = plan.bands.numpy()
    w = plan.weights.numpy() if weights is None else weights
    return np.stack([values[:, f:f + c] @ w[o:o + c] for f, c, o in zip(first, count, offset)],
                    1)


def _emulate_k1(frames: np.ndarray, plan, n_mels: int, amin: float = 1e-10):
    """(N, n_fft) float32 frames -> (power (N, n_fft/2 + 1), dB (N, n_mels))
    through the stages of the kernel whose plan this is: `emulate_rfft` or
    `emulate_mixed_rfft`, the power, the sparse mel sums and the log."""
    x = (emulate_rfft if isinstance(plan, FftMelPlan) else emulate_mixed_rfft)(frames, plan)
    power = x.real * x.real + x.imag * x.imag
    mel = band_sums(power, plan)
    return power, 10.0 * np.log10(np.maximum(mel, np.float32(amin)))


def _plan(n_fft, n_mels=NMELS):
    """The tables of the FFT kernel that takes n_fft: the register or the
    mixed-radix kernel's."""
    make = fft_mel_plan if kernel_path(n_fft) == "fft" else mixed_fft_plan
    return make(n_fft, n_mels, SR, 0.0, None, torch.device("cpu"))


# The mixed-radix kernel's n_fft: 50 ms at 24 kHz, 25 ms, 40 ms at 16 kHz,
# 20 ms at 44.1 kHz, 40 ms at 44.1 kHz, 40 ms at 48 kHz
MIXED_N_FFT = (1200, 600, 640, 882, 1764, 1920)
FFT_N_FFT = KERNEL_N_FFT + MIXED_N_FFT  # both FFT kernels


@pytest.fixture(scope="module", params=FFT_N_FFT)
def fft_case(request):
    """A seeded waveform of 12 frames at this n_fft (hop n_fft / 2), its
    JAX frames and the JAX rFFT oracle's dB."""
    n_fft = request.param
    wave = np.random.default_rng(n_fft).standard_normal(6 * n_fft).astype(np.float32)
    fr = np.array(frame_signal(jnp.asarray(wave), n_fft, n_fft // 2))
    oracle = np.asarray(log_mel_spectrogram(jnp.asarray(wave), n_fft=n_fft,
                                            hop_length=n_fft // 2)).T
    return n_fft, fr, oracle


def test_fft_plan_power_matches_numpy_rfft(fft_case):
    n_fft, fr, _ = fft_case
    power, _ = _emulate_k1(fr, _plan(n_fft), NMELS)
    spec = np.fft.rfft(fr.astype(np.float64) * hann_window(n_fft).astype(np.float64), axis=-1)
    want = spec.real ** 2 + spec.imag ** 2
    # float32 FFT against float64: 1e-5 of each bin, or of its frame's
    # mean power where a bin lies near zero
    np.testing.assert_allclose(power, want, rtol=1e-5,
                               atol=1e-6 * want.mean(axis=1, keepdims=True).max())
    assert np.abs(power - want).max() <= 1e-5 * want.max()


def test_fft_plan_matches_plain_k1(fft_case):
    n_fft, fr, _ = fft_case
    _, got = _emulate_k1(fr, _plan(n_fft), NMELS)
    want = log_mel_frames_reference(torch.from_numpy(fr)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fft_plan_matches_pallas_and_jax_oracle(fft_case):
    n_fft, fr, oracle = fft_case
    _, got = _emulate_k1(fr, _plan(n_fft), NMELS)
    assert got.shape == oracle.shape == (fr.shape[0], NMELS)
    np.testing.assert_allclose(got, oracle, atol=DB_ATOL, rtol=0)
    if n_fft // 2 + 1 <= 512:  # the Pallas kernel pads the bins to 512 lanes
        pallas = np.asarray(log_mel_frames_pallas(jnp.asarray(fr), interpret=True))
        np.testing.assert_allclose(got, pallas, atol=DB_ATOL, rtol=0)


@pytest.mark.parametrize("n_mels", [40, 64])
@pytest.mark.parametrize("n_fft", FFT_N_FFT)
def test_sparse_filterbank_expands_to_mel_filterbank(n_fft, n_mels):
    plan = _plan(n_fft, n_mels)
    first, count, offset = plan.bands.numpy()
    w = plan.weights.numpy()
    dense = np.zeros((n_fft // 2 + 1, n_mels), np.float32)
    for band, (f, c, o) in enumerate(zip(first, count, offset)):
        dense[f:f + c, band] = w[o:o + c]
    np.testing.assert_array_equal(dense, mel_filterbank(n_fft // 2 + 1, n_mels, SR))
    assert offset[-1] + count[-1] == w.size <= 2 * (n_fft // 2 + 1)  # a bin in two bands at most


@pytest.mark.parametrize("n_fft", FFT_N_FFT)
def test_fft_plan_fewer_mels_and_silence(n_fft):
    fr = np.random.default_rng(7).standard_normal((5, n_fft)).astype(np.float32)
    _, got = _emulate_k1(fr, _plan(n_fft, 40), 40)
    want = log_mel_frames_reference(torch.from_numpy(fr), n_mels=40).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _, silent = _emulate_k1(np.zeros((2, n_fft), np.float32), _plan(n_fft), NMELS)
    np.testing.assert_allclose(silent, -100.0, atol=1e-4)


def test_log_mel_frames_takes_frame_signal_view():
    """A CPU (C, T, n_fft) view of the padded waveform gives what its
    contiguous (C * T, n_fft) copy gives, in the view's shape."""
    wave = torch.from_numpy(
        (0.1 * np.random.default_rng(3).standard_normal((4, SR // 2))).astype(np.float32))
    view = port_mel.frame_signal(wave, NFFT, HOP)
    assert not view.is_contiguous() and view.stride()[1:] == (HOP, 1)
    got = log_mel_frames(view)
    want = log_mel_frames(view.contiguous().reshape(-1, NFFT))
    assert got.shape == (4, 1 + SR // 2 // HOP, NMELS)
    np.testing.assert_array_equal(got.reshape(-1, NMELS).numpy(), want.numpy())


@pytest.mark.parametrize("n_fft,n_mels", [(976, 64), (480, 64), (4096, 64), (960, 65), (960, 0)])
def test_kernel_shape_check_names_what_the_card_cannot_take(n_fft, n_mels):
    """The card takes every n_fft (one of three kernels, by kernel_path) and
    1 to 64 mels."""
    if 1 <= n_mels <= 64:
        check_kernel_shape(n_fft, n_mels)
    else:
        with pytest.raises(ValueError, match="K1's CUDA kernel"):
            check_kernel_shape(n_fft, n_mels)
    with pytest.raises(ValueError, match="K1's CUDA kernel"):
        check_kernel_shape(0, 64)
    for ok in KERNEL_N_FFT:
        check_kernel_shape(ok, 64)
    with pytest.raises(ValueError, match="K1's FFT kernel"):
        fft_mel_plan(n_fft if n_fft not in KERNEL_N_FFT else 976, 64, SR, 0.0, None,
                     torch.device("cpu"))
    # the CPU path takes any n_fft
    got = log_mel_frames(torch.zeros((2, 976)), n_fft=976)
    np.testing.assert_allclose(got.numpy(), -100.0, atol=1e-4)


def _expected_path(n_fft: int) -> str:
    """kernel_path's rule, written out again: the register FFT at its four
    n_fft, the mixed-radix FFT at an even n_fft from 64 to 4096 whose half
    has no prime factor above 7, the DFT tiles everywhere else."""
    if n_fft in KERNEL_N_FFT:
        return "fft"
    half = n_fft // 2
    for p in (2, 3, 5, 7):
        while half % p == 0:
            half //= p
    return "mixed" if n_fft % 2 == 0 and 64 <= n_fft <= 4096 and half == 1 else "dft"


@pytest.mark.parametrize("n_fft,path", [
    (17, "dft"), (60, "dft"), (64, "mixed"), (512, "fft"), (600, "mixed"), (640, "mixed"),
    (882, "mixed"), (960, "fft"), (1200, "mixed"), (1202, "dft"), (1764, "mixed"),
    (1920, "mixed"), (2048, "fft"), (4096, "mixed"), (4097, "dft"), (4116, "dft"),
])
def test_kernel_path_routes_each_n_fft(n_fft, path):
    """17 is odd, 60 has a 7-smooth half below the floor (M = 30 < 32: K4's
    64 lags would overlap), 1202 = 2 x 601, 4116 = 2 x 2 x 3 x 7^3 is past
    the cap; the mixed-radix plan refuses what it does not take."""
    assert kernel_path(n_fft) == path == _expected_path(n_fft)
    if path == "mixed":
        plan = mixed_fft_plan(n_fft, NMELS, SR, 0.0, None, torch.device("cpu"))
        radices = plan.radices.tolist()
        assert np.prod(radices) == n_fft // 2 and radices == sorted(radices, reverse=True)
        assert set(radices) <= {2, 3, 4, 5, 7, 8} and radices.count(2) + radices.count(4) <= 1
    else:
        with pytest.raises(ValueError, match="mixed-radix"):
            mixed_fft_plan(n_fft, NMELS, SR, 0.0, None, torch.device("cpu"))


def test_kernel_path_sweep_512_to_4097():
    lo, hi = MIXED_N_FFT_RANGE
    paths = {n: kernel_path(n) for n in range(512, 4098)}
    assert all(path == _expected_path(n) for n, path in paths.items())
    assert [n for n, p in paths.items() if p == "fft"] == list(KERNEL_N_FFT)
    mixed = [n for n, p in paths.items() if p == "mixed"]
    assert (lo, hi) == (64, 4096) and mixed[-1] == hi and {1200, 1764, 1920} <= set(mixed)
    assert mixed_radices(1) == () and mixed_radices(601) is None


def test_mixed_plan_tables():
    """Twiddles W_M^j and split twiddles -(i/2) W_N^k from float64, the
    butterflies' constants W_3^1, W_5^1, W_5^2, W_7^1..3, W_8^1."""
    plan = mixed_fft_plan(1200, NMELS, SR, 0.0, None, torch.device("cpu"))
    j = np.arange(600)
    np.testing.assert_allclose(_complex(plan.twiddles), np.exp(-2j * np.pi * j / 600), atol=1e-7)
    np.testing.assert_allclose(_complex(plan.split_twiddles),
                               -0.5j * np.exp(-2j * np.pi * j / 1200), atol=1e-7)
    want = [np.exp(-2j * np.pi * a / b) for a, b in ((1, 3), (1, 5), (2, 5), (1, 7), (2, 7),
                                                    (3, 7), (1, 8))] + [0]
    np.testing.assert_allclose(_complex(plan.consts), want, atol=1e-7)
    np.testing.assert_array_equal(plan.window.numpy(), hann_window(1200))


# The DFT-tile kernel takes every n_fft; it runs where neither FFT kernel
# does (1202 = 2 x 601), and its emulation is held at 1200 and 600 too,
# where it ran before the mixed-radix kernel (600: not a multiple of the
# 16-deep tile)
DFT_N_FFT = (1200, 600, 1202)


def emulate_dft_planes(frames: np.ndarray, c_re: np.ndarray, c_im: np.ndarray, n_fft: int,
                       chunk_fn) -> None:
    """The DFT-as-tiles kernels' first stage in their loop order: per
    64-bin chunk, re and im as float32 sums over the padded depth (frames
    read as zeros past n_fft), then chunk_fn(b0, re, im) for the chunk's
    projections."""
    depth, n_bins = c_re.shape
    a = np.zeros((frames.shape[0], depth), np.float32)
    a[:, :n_fft] = frames
    for b0 in range(0, n_bins, 64):
        re = np.zeros((frames.shape[0], 64), np.float32)
        im = np.zeros_like(re)
        for k in range(depth):
            re += a[:, k:k + 1] * c_re[k, b0:b0 + 64]
            im += a[:, k:k + 1] * c_im[k, b0:b0 + 64]
        chunk_fn(b0, re, im)


def emulate_dft_k1(frames: np.ndarray, n_fft: int, n_mels: int, amin: float = 1e-10):
    """(N, n_fft) float32 frames -> (N, n_mels) dB through the DFT kernel's
    stages on `dft_kernel_constants`: the padded DFT tiles, the power tile,
    the chunk's filterbank rows added to the mel sums bin by bin, the log."""
    c_re, c_im, fb = (x.numpy() for x in dft_kernel_constants(
        n_fft, n_mels, SR, 0.0, None, torch.device("cpu")))
    mel = np.zeros((frames.shape[0], fb.shape[1]), np.float32)

    def project(b0, re, im):
        power = re * re + im * im
        for b in range(64):
            mel[:] += power[:, b:b + 1] * fb[b0 + b]

    emulate_dft_planes(frames, c_re, c_im, n_fft, project)
    return 10.0 * np.log10(np.maximum(mel[:, :n_mels], np.float32(amin)))


@pytest.mark.parametrize("n_fft", DFT_N_FFT)
def test_dft_kernel_constants_pad_the_depth(n_fft):
    c_re, c_im, fb = dft_kernel_constants(n_fft, NMELS, SR, 0.0, None, torch.device("cpu"))
    assert c_re.shape[0] % 16 == 0 and n_fft <= c_re.shape[0] < n_fft + 16
    assert c_re.shape[1] % 64 == 0 and fb.shape == (c_re.shape[1], 64)
    assert not c_re[n_fft:].any() and not c_im[n_fft:].any()
    plain_re = port_mel.hann_window(n_fft)[:, None] * np.cos(
        -2 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_fft // 2 + 1) / n_fft)
    np.testing.assert_allclose(c_re[:n_fft, :n_fft // 2 + 1].numpy(), plain_re, atol=1e-6)


@pytest.mark.parametrize("n_fft", DFT_N_FFT)
def test_dft_kernel_emulation_matches_plain_pallas_and_jax(n_fft):
    """The general-n_fft kernel's emulation against the plain version (the
    same float32 products in another order: 1e-4 dB, as the FFT path's
    emulation), the JAX rFFT oracle and, where it takes the n_fft (the bins
    fit its 512 lanes), the Pallas kernel, at the fused kernel's bar."""
    wave = np.random.default_rng(n_fft).standard_normal(6 * n_fft).astype(np.float32)
    fr = np.array(frame_signal(jnp.asarray(wave), n_fft, n_fft // 2))
    got = emulate_dft_k1(fr, n_fft, NMELS)
    plain = log_mel_frames_reference(torch.from_numpy(fr)).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-4, rtol=0)
    oracle = np.asarray(log_mel_spectrogram(jnp.asarray(wave), n_fft=n_fft,
                                            hop_length=n_fft // 2)).T
    np.testing.assert_allclose(got, oracle, atol=DB_ATOL, rtol=0)
    if n_fft // 2 + 1 <= 512:
        pallas = np.asarray(log_mel_frames_pallas(jnp.asarray(fr), interpret=True))
        np.testing.assert_allclose(got, pallas, atol=DB_ATOL, rtol=0)
    silent = emulate_dft_k1(np.zeros((2, n_fft), np.float32), n_fft, NMELS)
    np.testing.assert_allclose(silent, -100.0, atol=1e-4)
