"""The port's spatial front-end against seld_tpu's: kernel K4's plain
version (the float32 GEMMs its wrapper runs on the CPU) against the
Pallas kernel in interpret mode and the rFFT oracle; numpy emulations of
the CUDA kernels' stage orders, on the tables of `spatial_plan` (K1's
register FFT per channel, the sparse band sums, the pruned inverse FFT
of the GCC planes, at every n_fft that kernel takes) and of
`mixed_spatial_plan` (K1's mixed-radix FFT per channel, the band sums, a
full inverse FFT of the GCC planes by the same passes, at n_fft 1200,
600, 640, 882, 1764 and 1920), against the plain version, the Pallas
kernel and the JAX oracle, and of the general-n_fft DFT kernel at n_fft
1200, 600 and 1202; the port's own rFFT oracle,
the corpus entry point for "mel_iv" and "mel_gcc", and the slice as a
whole: a small "mel_iv" flagship with the same weights, fed the same
features and served from the same waveform."""

import dataclasses
import itertools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import Config, FeatureConfig, ModelConfig, WindowConfig
from seld_tpu.data.corpus import compute_mel_features as jax_compute_mel_features
from seld_tpu.features.spatial import extract_feature_frames as jax_extract
from seld_tpu.features.spatial import feature_channels as jax_feature_channels
from seld_tpu.models import build_model
from seld_tpu.ops.spatial_pallas import _constants as jax_constants
from seld_tpu.ops.spatial_pallas import spatial_features_pallas
from seld_tpu_torch.config import FeatureConfig as PortFeatureConfig
from seld_tpu_torch.config import ModelConfig as PortModelConfig
from seld_tpu_torch.config import config_from_dict
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.data.corpus import compute_mel_features
from seld_tpu_torch.features import spatial as port_spatial
from seld_tpu_torch.features.mel import frame_signal
from seld_tpu_torch.infer import SELDPredictor
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.ops import mel_cuda, spatial_cuda
from seld_tpu_torch.ops.mel_cuda import KERNEL_N_FFT, bit_reverse5, kernel_path
from seld_tpu_torch.ops.spatial_cuda import (
    check_kernel_shape,
    mixed_spatial_plan,
    spatial_constants,
    spatial_features,
    spatial_features_reference,
    spatial_plan,
)
from seld_tpu_torch.train.checkpoint import save_checkpoint
from tests import test_torch_mel
from tests.test_torch_mel import (
    FFT_N_FFT,
    MIXED_N_FFT,
    _complex,
    band_sums,
    emulate_mixed_rfft,
    emulate_rfft,
    emulate_stockham,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SR, NFFT, HOP, NMELS = 24_000, 960, 480, 64
SETS = ("mel", "mel_iv", "mel_gcc")
# tests/test_pallas_kernels.py's bars for the fused spatial kernel: the mel
# planes in dB as for K1, the intensity-vector and GCC planes in [-1, 1]
DB_ATOL, PLANE_ATOL = 5e-3, 1e-4
# the flagship's bar (tests/test_torch_model.py): float32 in another order
ATOL, RTOL = 5e-4, 1e-3
MARGIN = 1e-3  # argmax decisions may differ only inside this top-2 margin


def _assert_features_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=DB_ATOL, rtol=0)
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=PLANE_ATOL, rtol=0)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).standard_normal((4, 37, NFFT)).astype(np.float32)


@pytest.mark.parametrize("feature_set", SETS)
@pytest.mark.parametrize("n_audio", [2, 4])
def test_feature_channels_match_jax(feature_set, n_audio):
    assert (port_spatial.feature_channels(feature_set, n_audio)
            == jax_feature_channels(feature_set, n_audio))
    assert port_spatial.FEATURE_CHANNELS[feature_set] == jax_feature_channels(feature_set)


def test_unknown_feature_set_raises():
    with pytest.raises(ValueError, match="unknown feature_set"):
        port_spatial.feature_channels("mel_xyz")
    with pytest.raises(ValueError, match="unknown feature_set"):
        compute_mel_features(np.zeros((4, 960), np.float32),
                             PortFeatureConfig(feature_set="mel_xyz"), device="cpu")


def test_constants_match_jax():
    got = [c.numpy() for c in spatial_constants(NFFT, NMELS, SR, torch.device("cpu"))]
    want = jax_constants(NFFT, NMELS, SR)
    assert got[0].shape == (NFFT, 512) and got[2].shape == (512, 64)
    for g, w in zip(got[:2], want[:2]):  # DFT bases: the same bins, padded alike
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[2:], want[2:]):  # projections: the TPU pads columns to 128
        np.testing.assert_array_equal(g, w[:, :64])
        assert not w[:, 64:].any()


@pytest.mark.parametrize("feature_set", SETS)
def test_plain_k4_matches_pallas_interpret(frames, feature_set):
    got = spatial_features(torch.from_numpy(frames), feature_set).numpy()
    want = np.asarray(spatial_features_pallas(jnp.asarray(frames), feature_set,
                                              interpret=True))
    _assert_features_close(got, want)


@pytest.mark.parametrize("feature_set", SETS)
def test_plain_k4_matches_jax_oracle(frames, feature_set):
    got = spatial_features_reference(torch.from_numpy(frames), feature_set).numpy()
    want = np.asarray(jax_extract(jnp.asarray(frames), feature_set, NFFT, NMELS, SR))
    _assert_features_close(got, want)


@pytest.mark.parametrize("feature_set", SETS)
def test_port_oracle_matches_jax_oracle(frames, feature_set):
    got = port_spatial.extract_feature_frames(torch.from_numpy(frames), feature_set,
                                              NFFT, NMELS, SR).numpy()
    want = np.asarray(jax_extract(jnp.asarray(frames), feature_set, NFFT, NMELS, SR))
    _assert_features_close(got, want)


@pytest.mark.parametrize("feature_set", SETS)
def test_plain_k4_on_silence_is_finite(feature_set):
    got = spatial_features(torch.zeros((4, 5, NFFT)), feature_set).numpy()
    np.testing.assert_allclose(got[:, :4], -100.0, atol=1e-4)  # 10*log10(1e-10)
    assert np.isfinite(got).all() and not got[:, 4:].any()


def test_plain_k4_fewer_mels_matches_pallas(frames):
    got = spatial_features(torch.from_numpy(frames), "mel_gcc", n_mels=40).numpy()
    want = np.asarray(spatial_features_pallas(jnp.asarray(frames), "mel_gcc", n_mels=40,
                                              interpret=True))
    assert got.shape == (37, 10, 40)
    _assert_features_close(got, want)


def test_gcc_lag_peak_of_a_delayed_channel():
    """tests/test_pallas_kernels.py's construction: channel 1 is channel 0
    delayed by 7 samples, so the pair (0, 1) peaks at lag +7."""
    rng = np.random.default_rng(0)
    n, delay = SR // 2, 7
    base = rng.standard_normal(n + 64).astype(np.float32)
    wave = np.stack([base[64:64 + n], base[64 - delay:64 - delay + n],
                     rng.standard_normal(n).astype(np.float32),
                     rng.standard_normal(n).astype(np.float32)])
    framed = frame_signal(torch.from_numpy(wave), NFFT, HOP).contiguous()
    for out in (spatial_features(framed, "mel_gcc"),
                port_spatial.extract_feature_frames(framed, "mel_gcc", NFFT, NMELS, SR)):
        assert int(out[:, 4].mean(dim=0).argmax()) == 32 + delay


@pytest.mark.parametrize("make,err", [
    (lambda: torch.zeros((4, 8, NFFT), dtype=torch.float64), TypeError),
    (lambda: torch.zeros((3, 8, NFFT)), ValueError),  # not 4 channels
    (lambda: torch.zeros((8, NFFT)), ValueError),  # wrong rank
    (lambda: torch.zeros((4, 8, 2 * NFFT))[..., ::2], ValueError),  # column stride 2
])
def test_k4_wrapper_checks_cpu_input(make, err):
    with pytest.raises(err):
        spatial_features(make(), "mel_iv")


@pytest.mark.parametrize("n_fft,n_mels", [(950, 64), (976, 64), (480, 64), (4096, 64),
                                          (960, 65), (960, 0)])
def test_kernel_shape_check_names_what_the_card_cannot_take(n_fft, n_mels):
    """The card takes every n_fft (the FFT kernel those of KERNEL_N_FFT, the
    DFT kernel the rest) and 1 to 64 mels."""
    if 1 <= n_mels <= 64:
        check_kernel_shape(n_fft, n_mels)
    else:
        with pytest.raises(ValueError, match="K4"):
            check_kernel_shape(n_fft, n_mels)
    with pytest.raises(ValueError, match="K4"):
        check_kernel_shape(0, 64)
    for ok in KERNEL_N_FFT:
        check_kernel_shape(ok, 64)
    with pytest.raises(ValueError, match="K4's FFT kernel"):
        spatial_plan(n_fft if n_fft not in KERNEL_N_FFT else 950, 64, SR, torch.device("cpu"))


@pytest.mark.parametrize("feature_set", SETS)
def test_plain_k4_computes_at_any_n_fft_on_cpu(feature_set):
    """n_fft = 950 is no n_fft of the CUDA kernel, but the CPU path takes
    it: the plain version against the JAX oracle."""
    fr = np.random.default_rng(950).standard_normal((4, 9, 950)).astype(np.float32)
    got = spatial_features(torch.from_numpy(fr), feature_set).numpy()
    want = np.asarray(jax_extract(jnp.asarray(fr), feature_set, 950, NMELS, SR))
    assert got.shape == (9, jax_feature_channels(feature_set), NMELS)
    _assert_features_close(got, want)


@pytest.mark.parametrize("feature_set", SETS)
def test_k4_takes_frame_signal_view_on_cpu(feature_set):
    """A CPU (4, T, n_fft) view of the padded waveform gives what its
    contiguous copy gives."""
    wave = torch.from_numpy(
        (0.1 * np.random.default_rng(4).standard_normal((4, SR // 4))).astype(np.float32))
    view = frame_signal(wave, NFFT, HOP)
    assert not view.is_contiguous() and view.stride()[1:] == (HOP, 1)
    got = spatial_features(view, feature_set)
    want = spatial_features(view.contiguous(), feature_set)
    assert got.shape == (1 + SR // 4 // HOP, jax_feature_channels(feature_set), NMELS)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_k4_wrapper_takes_plain_version_for_cpu_tensors(monkeypatch):
    calls = []
    plain = spatial_cuda.spatial_features_reference

    def spy(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return plain(*args, **kwargs)

    monkeypatch.setattr(spatial_cuda, "spatial_features_reference", spy)
    before = spatial_features.launches
    out = spatial_features(torch.zeros((4, 5, NFFT)), "mel_gcc")
    # one block of CPU_BLOCK_FRAMES frames, the 5 given and zero frames
    assert calls == [(4, mel_cuda.CPU_BLOCK_FRAMES, NFFT)] and out.shape == (5, 10, 64)
    assert spatial_features.launches == before  # no kernel launched


# --- the CUDA kernel's arithmetic, stage by stage, in float32 numpy ------


def emulate_lags(cross: np.ndarray, plan, n_mels: int) -> np.ndarray:
    """(N, n_fft/2 + 1) complex64 cross-spectra -> (N, n_mels) lags through
    the kernel's GCC stages: the bins in the forward stage's lane layout
    (only the real parts of bins 0 and M), the inverse real split, the
    five cross-lane stages inverted in the opposite order and the pruned
    lane sum with the lag twiddles."""
    m = cross.shape[1] - 1
    r = m // 32
    lanes = np.arange(32)
    k1 = bit_reverse5(lanes)
    z = cross[:, np.arange(r)[None, :] + r * k1[:, None]].astype(np.complex64)  # [., lane, reg]
    z[:, 0, 0] = z[:, 0, 0].real
    partner = np.empty_like(z)
    partner[:, :, 0] = z[:, bit_reverse5((32 - k1) % 32), 0]
    partner[:, 0, 0] = cross[:, m].real
    for j in range(1, r):
        partner[:, :, j] = z[:, lanes ^ 31, r - j]
    b = np.conj(partner)
    z = np.float32(0.5) * (z + b) + np.conj(_complex(plan.mel.split_twiddles).T) * (z - b)
    warp = np.conj(_complex(plan.mel.warp_twiddles))
    for s in range(4, -1, -1):
        h = 16 >> s
        v = z * warp[s][:, None] if s < 4 else z
        p = v[:, lanes ^ h]
        z = np.where(((lanes & h) != 0)[None, :, None], p - v, p + v)
    return _lag_columns((z * _complex(plan.lag_twiddles).T).sum(axis=2), n_mels)


def _lag_columns(acc: np.ndarray, n_mels: int) -> np.ndarray:
    """(N, 32) complex samples (x[2n], x[2n + 1]) of lane l's n = l (lanes
    0-15) or M - 32 + l (lanes 16-31) -> the (N, n_mels) lag columns."""
    lanes = np.arange(32)
    lag = np.where(lanes < 16, 2 * lanes, 2 * lanes - 64)
    out = np.zeros((acc.shape[0], n_mels), np.float32)
    for part, shift in ((acc.real, 0), (acc.imag, 1)):
        col = lag + shift + n_mels // 2
        keep = (col >= 0) & (col < n_mels)
        out[:, col[keep]] = part[:, keep]
    return out


def emulate_mixed_lags(cross: np.ndarray, plan, n_mels: int) -> np.ndarray:
    """(N, n_fft/2 + 1) complex64 cross-spectra -> (N, n_mels) lags through
    the mixed-radix kernel's GCC stages: the inverse real split in natural
    order (only the real parts of bins 0 and M), its conjugate through the
    forward Stockham passes, the conjugate of the samples the lags need,
    times 2 / n_fft."""
    m = cross.shape[1] - 1
    k = np.arange(m)
    a, b = cross[:, :m].astype(np.complex64), cross[:, m - k].astype(np.complex64)
    a[:, 0], b[:, 0] = a[:, 0].real, b[:, 0].real
    b = np.conj(b)
    z = np.float32(0.5) * (a + b) + np.conj(_complex(plan.mel.split_twiddles)) * (a - b)
    r = emulate_stockham(np.conj(z), plan.mel)
    lanes = np.arange(32)
    return _lag_columns(np.conj(r[:, np.where(lanes < 16, lanes, m - 32 + lanes)])
                        * np.float32(plan.scale), n_mels)


def _k4_stages(n_fft: int, n_mels: int):
    """(plan, forward stage, GCC stage) of the FFT kernel that takes n_fft:
    the register kernel's or the mixed-radix kernel's."""
    if kernel_path(n_fft) == "fft":
        return spatial_plan(n_fft, n_mels, SR, torch.device("cpu")), emulate_rfft, emulate_lags
    return (mixed_spatial_plan(n_fft, n_mels, SR, torch.device("cpu")), emulate_mixed_rfft,
            emulate_mixed_lags)


def emulate_k4(frames: np.ndarray, feature_set: str, n_mels: int, amin: float = 1e-10,
               eps: float = 1e-8) -> np.ndarray:
    """(4, T, n_fft) float32 frames -> (T, C_out, n_mels) through the
    stages of the FFT kernel that takes n_fft, on its plan's tables."""
    plan, rfft, lags = _k4_stages(frames.shape[2], n_mels)
    spec = [rfft(f, plan.mel) for f in frames]  # 4 x (T, M + 1)
    power = [x.real * x.real + x.imag * x.imag for x in spec]
    planes = [10.0 * np.log10(np.maximum(band_sums(p, plan.mel), np.float32(amin)))
              for p in power]
    w, y, z, x = range(4)  # ACN
    if feature_set == "mel_iv":
        energy = (power[w] + (power[x] + power[y] + power[z]) / np.float32(3)) / np.float32(2)
        inv_e = np.float32(1) / (energy + np.float32(eps))
        for c in (x, y, z):
            iv = (spec[w].real * spec[c].real + spec[w].imag * spec[c].imag) * inv_e
            planes.append(band_sums(iv, plan.mel, plan.norm_weights.numpy()))
    elif feature_set == "mel_gcc":
        for i, j in itertools.combinations(range(4), 2):
            cross = np.conj(spec[i]) * spec[j]
            mag = cross.real * cross.real + cross.imag * cross.imag + np.float32(eps) ** 2
            planes.append(lags(cross / np.sqrt(mag), plan, n_mels))
    return np.stack(planes, axis=1)


def _frames_at(n_fft: int) -> np.ndarray:
    """(4, 9, n_fft) frames of a seeded 4-channel waveform, hop n_fft / 2."""
    wave = np.random.default_rng(n_fft).standard_normal((4, 8 * n_fft // 2)).astype(np.float32)
    return frame_signal(torch.from_numpy(wave), n_fft, n_fft // 2).contiguous().numpy()


@pytest.mark.parametrize("n_mels", [64, 40])
@pytest.mark.parametrize("feature_set", SETS)
@pytest.mark.parametrize("n_fft", FFT_N_FFT)
def test_emulated_k4_matches_plain(n_fft, feature_set, n_mels):
    fr = _frames_at(n_fft)
    got = emulate_k4(fr, feature_set, n_mels)
    want = spatial_features_reference(torch.from_numpy(fr), feature_set, n_mels).numpy()
    assert got.shape == want.shape == (9, jax_feature_channels(feature_set), n_mels)
    # float32 FFTs against float32 GEMMs (tests/test_torch_mel.py holds K1's
    # emulation to its plain version at the same 1e-4 dB); the mixed-radix
    # sizes' other planes at K4's bar PLANE_ATOL, as the DFT path's: at
    # n_fft 1200 the plain version's GCC planes lie 1.9e-5 from a float64
    # computation of them, the emulation's 1e-6
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], rtol=0,
                               atol=1e-5 if kernel_path(n_fft) == "fft" else PLANE_ATOL)


@pytest.mark.parametrize("n_mels", [64, 40])
@pytest.mark.parametrize("feature_set", SETS)
@pytest.mark.parametrize("n_fft", KERNEL_N_FFT)
def test_emulated_k4_matches_pallas_and_jax_oracle(n_fft, feature_set, n_mels):
    """The Pallas kernel where it takes the n_fft (it pads the bins to 512
    lanes), the JAX rFFT oracle at every n_fft."""
    fr = _frames_at(n_fft)
    got = emulate_k4(fr, feature_set, n_mels)
    oracle = np.asarray(jax_extract(jnp.asarray(fr), feature_set, n_fft, n_mels, SR))
    _assert_features_close(got, oracle)
    if n_fft // 2 + 1 <= 512:
        pallas = np.asarray(spatial_features_pallas(jnp.asarray(fr), feature_set, n_mels=n_mels,
                                                    interpret=True))
        _assert_features_close(got, pallas)


@pytest.mark.parametrize("feature_set", ["mel_iv", "mel_gcc"])
@pytest.mark.parametrize("n_fft", MIXED_N_FFT)
def test_emulated_mixed_k4_matches_pallas_and_jax_oracle(n_fft, feature_set):
    """The mixed-radix kernel's emulation against the JAX rFFT oracle at
    every n_fft it is held to here, and the Pallas kernel where that takes
    the n_fft (600, 640, 882), at the fused kernel's bars; both sets carry
    the 4 mel planes ("mel" alone is test_emulated_k4_matches_plain's)."""
    fr = _frames_at(n_fft)
    got = emulate_k4(fr, feature_set, NMELS)
    _assert_features_close(got, np.asarray(jax_extract(jnp.asarray(fr), feature_set, n_fft,
                                                       NMELS, SR)))
    if n_fft // 2 + 1 <= 512:
        _assert_features_close(got, np.asarray(spatial_features_pallas(
            jnp.asarray(fr), feature_set, n_mels=NMELS, interpret=True)))


def emulate_dft_k4(frames: np.ndarray, feature_set: str, n_mels: int, amin: float = 1e-10,
                   eps: float = 1e-8) -> np.ndarray:
    """(4, T, n_fft) float32 frames -> (T, C_out, n_mels) through the
    general-n_fft kernel's stages (fault F2) on `dft_kernel_constants`: the
    padded DFT tiles per channel, each 64-bin chunk's derived planes from
    the four channels' re / im, their products with the chunk's projection
    rows added bin by bin, the log of the mel planes."""
    n_fft = frames.shape[2]
    c_re, c_im, fb, fb_norm, lag_re, lag_im = (x.numpy() for x in spatial_cuda.
                                                dft_kernel_constants(n_fft, n_mels, SR,
                                                                     torch.device("cpu")))
    t = frames.shape[1]
    n_out = jax_feature_channels(feature_set)
    acc = np.zeros((n_out, t, 64), np.float32)
    xyz = (port_spatial._ACN_X, port_spatial._ACN_Y, port_spatial._ACN_Z)
    w = port_spatial._ACN_W

    def project(b0, re, im):
        re, im = re.reshape(4, t, 64), im.reshape(4, t, 64)
        power = re * re + im * im
        planes = [(p, fb) for p in power]
        if feature_set == "mel_iv":
            energy = (power[w] + (power[xyz[0]] + power[xyz[1]] + power[xyz[2]])
                      / np.float32(3)) / np.float32(2) + np.float32(eps)
            inv_e = np.float32(1) / energy
            planes += [((re[w] * re[c] + im[w] * im[c]) * inv_e, fb_norm) for c in xyz]
        elif feature_set == "mel_gcc":
            for i, k in itertools.combinations(range(4), 2):
                cr = re[i] * re[k] + im[i] * im[k]
                ci = re[i] * im[k] - im[i] * re[k]
                inv = np.float32(1) / np.sqrt(cr * cr + ci * ci + np.float32(eps * eps))
                planes.append(((cr * inv, ci * inv), (lag_re, lag_im)))
        for o, (plane, mat) in enumerate(planes):
            for b in range(64):
                if isinstance(mat, tuple):
                    acc[o] += plane[0][:, b:b + 1] * mat[0][b0 + b] \
                        + plane[1][:, b:b + 1] * mat[1][b0 + b]
                else:
                    acc[o] += plane[:, b:b + 1] * mat[b0 + b]

    test_torch_mel.emulate_dft_planes(frames.reshape(4 * t, n_fft), c_re, c_im, n_fft,
                                      project)
    acc[:4] = 10.0 * np.log10(np.maximum(acc[:4], np.float32(amin)))
    return acc[:, :, :n_mels].transpose(1, 0, 2)


@pytest.mark.parametrize("feature_set", SETS)
@pytest.mark.parametrize("n_fft", test_torch_mel.DFT_N_FFT)
def test_dft_kernel_emulation_matches_plain_pallas_and_jax(n_fft, feature_set):
    """The general-n_fft kernel's emulation against the plain version (1e-4
    dB on the mel planes, as the FFT path's emulation; the other planes at
    the fused kernel's PLANE_ATOL: a sum of n_fft float32 terms in order
    against a blocked GEMM, and PHAT's normalisation magnifies the
    difference on the faint bins, 1.3e-5 measured at n_fft 1200), the JAX
    rFFT oracle and, where it takes the n_fft, the Pallas kernel, at the
    fused kernel's bars."""
    fr = _frames_at(n_fft)
    got = emulate_dft_k4(fr, feature_set, NMELS)
    want = spatial_features_reference(torch.from_numpy(fr), feature_set, NMELS).numpy()
    assert got.shape == want.shape == (9, jax_feature_channels(feature_set), NMELS)
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[:, 4:], want[:, 4:], atol=PLANE_ATOL, rtol=0)
    _assert_features_close(got, np.asarray(jax_extract(jnp.asarray(fr), feature_set, n_fft,
                                                       NMELS, SR)))
    if n_fft // 2 + 1 <= 512:
        _assert_features_close(got, np.asarray(spatial_features_pallas(
            jnp.asarray(fr), feature_set, n_mels=NMELS, interpret=True)))


@pytest.mark.parametrize("n_fft", FFT_N_FFT)
def test_emulated_k4_on_silence(n_fft):
    got = emulate_k4(np.zeros((4, 3, n_fft), np.float32), "mel_gcc", NMELS)
    np.testing.assert_allclose(got[:, :4], -100.0, atol=1e-4)
    assert not got[:, 4:].any()
    got = emulate_k4(np.zeros((4, 3, n_fft), np.float32), "mel_iv", NMELS)
    assert not got[:, 4:].any()


@pytest.mark.parametrize("n_mels", [64, 40])
@pytest.mark.parametrize("n_fft", FFT_N_FFT)
def test_packed_norm_filterbank_expands_to_fb_norm(n_fft, n_mels):
    plan = _k4_stages(n_fft, n_mels)[0]
    first, count, offset = plan.mel.bands.numpy()
    w = plan.norm_weights.numpy()
    assert w.size == plan.mel.weights.numel()
    dense = np.zeros((n_fft // 2 + 1, n_mels), np.float32)
    for band, (f, c, o) in enumerate(zip(first, count, offset)):
        dense[f:f + c, band] = w[o:o + c]
    fb_norm = spatial_constants(n_fft, n_mels, SR, torch.device("cpu"))[3].numpy()
    np.testing.assert_array_equal(dense, fb_norm[:n_fft // 2 + 1, :n_mels])
    assert not fb_norm[n_fft // 2 + 1:].any() and not fb_norm[:, n_mels:].any()


@pytest.mark.parametrize("n_mels", [64, 40])
@pytest.mark.parametrize("n_fft", FFT_N_FFT)
def test_emulated_pruned_inverse_matches_lag_matrices(n_fft, n_mels):
    """Any cross-spectrum, not only a PHAT-normalised one: the pruned
    inverse FFT is the product with the TPU kernel's lag matrices."""
    rng = np.random.default_rng(n_fft + n_mels)
    m = n_fft // 2
    cross = (rng.standard_normal((5, m + 1)) + 1j * rng.standard_normal((5, m + 1))
             ).astype(np.complex64)
    plan, _, lags = _k4_stages(n_fft, n_mels)
    got = lags(cross, plan, n_mels)
    lag_re, lag_im = (c.numpy()[:m + 1, :n_mels]
                      for c in spatial_constants(n_fft, n_mels, SR, torch.device("cpu"))[4:])
    want = cross.real @ lag_re + cross.imag @ lag_im
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_fft", [960, 1200, 882])
def test_emulated_gcc_lag_peak_of_a_delayed_channel(n_fft):
    """The FFT kernels' GCC stages on test_gcc_lag_peak_of_a_delayed_channel's
    construction, framed at n_fft with hop n_fft / 2: the pair (0, 1) peaks
    at lag +7 (the register kernel at 960, the mixed-radix kernel at 1200
    and 882, an odd M = 441)."""
    rng = np.random.default_rng(0)
    n, delay = 8 * n_fft, 7
    base = rng.standard_normal(n + 64).astype(np.float32)
    wave = np.stack([base[64:64 + n], base[64 - delay:64 - delay + n],
                     rng.standard_normal(n).astype(np.float32),
                     rng.standard_normal(n).astype(np.float32)])
    framed = frame_signal(torch.from_numpy(wave), n_fft, n_fft // 2).contiguous().numpy()
    got = emulate_k4(framed, "mel_gcc", NMELS)
    assert int(got[:, 4].mean(axis=0).argmax()) == 32 + delay


@pytest.mark.parametrize("feature_set", ["mel_iv", "mel_gcc"])
def test_compute_mel_features_matches_jax(feature_set):
    wave = (0.1 * np.random.default_rng(2).standard_normal((4, SR // 2))).astype(np.float32)
    want = jax_compute_mel_features(wave, FeatureConfig(feature_set=feature_set))
    got = compute_mel_features(wave, PortFeatureConfig(feature_set=feature_set),
                               device="cpu").numpy()
    assert got.shape == (1 + SR // 2 // HOP, jax_feature_channels(feature_set), NMELS)
    _assert_features_close(got, want)


# --- the slice as a whole: a small mel_iv flagship ------------------------

SMALL = dict(resnet_conf_d_model=16, resnet_conf_n_heads=2, resnet_conf_n_layers=1,
             compute_dtype="float32")


def _random_variables(model, x0, seed=0):
    """numpy variables of the JAX model for input x0, drawn from a seed:
    the tree's shapes from jax.eval_shape (no init compile), kernels from
    N(0, 1/fan_in), random norm scales and biases and BatchNorm statistics,
    so that a layout mistake cannot hide behind the 0/1 init and the
    decoded grid holds many classes."""
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda: model.init({"params": key, "dropout": key}, x0,
                                               train=False))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        keys = [getattr(p, "key", str(p)) for p in path]
        if keys[0] == "batch_stats":
            if keys[-1] == "mean":
                return rng.normal(0, 0.05, x.shape).astype(np.float32)
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if keys[-1] == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if keys[-1] == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        fan_in = x.shape[0] if "logits" in keys else int(np.prod(x.shape[:-1]))
        return (rng.standard_normal(x.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


WIN = 10  # 0.2 s windows
N_WIN = 6  # a 1 s clip: 51 frames in 6 windows


@pytest.fixture(scope="module")
def iv_flagship():
    """(JAX config, jitted JAX forward, numpy variables, port model): flax
    infers the 7-channel stem from a mel_iv input; the port builds it from
    the count."""
    cfg = dataclasses.replace(
        Config(), model=ModelConfig(**SMALL),
        features=FeatureConfig(feature_set="mel_iv"),
        window=WindowConfig(window_seconds=0.2, hop_seconds=0.2),
    )
    model = build_model(cfg.model, cfg.grid)
    variables = _random_variables(model, jnp.zeros((N_WIN, WIN, 7, NMELS), jnp.float32))
    forward = jax.jit(lambda v, x: model.apply(v, x, train=False))
    port = build_port_model(PortModelConfig(**SMALL), device="cpu", seed=None,
                            in_channels=7)
    port.load_state_dict(state_dict_from_jax(variables, PortModelConfig(**SMALL)))
    return cfg, forward, variables, port


@pytest.mark.parametrize("channels", [7, 10])
def test_wider_stem_kernels_convert(iv_flagship, channels):
    _, _, variables, _ = iv_flagship
    kernel = np.random.default_rng(channels).standard_normal((3, 3, channels, 64))
    variables = jax.tree.map(np.copy, variables)
    variables["params"]["ResNet50Encoder_0"]["stem"]["kernel"] = kernel.astype(np.float32)
    port = build_port_model(PortModelConfig(**SMALL), device="cpu", seed=0,
                            in_channels=channels)
    assert port.encoder.stem.weight.shape == (64, channels, 3, 3)
    port.load_state_dict(state_dict_from_jax(variables, PortModelConfig(**SMALL)))
    np.testing.assert_array_equal(port.encoder.stem.weight.detach().numpy(),
                                  kernel.astype(np.float32).transpose(3, 2, 0, 1))


def test_mel_iv_flagship_logits_match_jax(iv_flagship):
    _, forward, variables, port = iv_flagship
    x = np.random.default_rng(1).standard_normal((N_WIN, WIN, 7, NMELS)).astype(np.float32)
    want = np.asarray(forward(variables, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (N_WIN, WIN, 14, 648)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_mel_iv_predictor_from_the_waveform_matches_jax(iv_flagship, tmp_path):
    """A checkpoint stores its config: SELDPredictor rebuilds the 7-channel
    model from it and computes the features through K4's plain version; the
    JAX side runs its own features (the jnp oracle) and model on the same
    window tiling. Grids agree outside the top-2 margin."""
    from seld_tpu.config import config_to_dict

    cfg, forward, variables, port = iv_flagship
    port_cfg = config_from_dict(config_to_dict(cfg))
    save_checkpoint(tmp_path / "iv.pt", port, port_cfg)
    pred = SELDPredictor(tmp_path / "iv.pt", batch_windows=4, device="cpu")
    assert pred.model.encoder.stem.weight.shape[1] == 7

    wave = (0.1 * np.random.default_rng(3).standard_normal((4, SR))).astype(np.float32)
    got = pred.predict_waveform(wave).classes
    feats = jax_compute_mel_features(wave, cfg.features)  # (51, 7, 64)
    t = feats.shape[0]
    assert cfg.window.window_frames(cfg.features) == WIN and -(-t // WIN) == N_WIN
    padded = np.concatenate([feats, np.zeros((N_WIN * WIN - t, 7, NMELS), np.float32)])
    logits = np.asarray(forward(variables, padded.reshape(N_WIN, WIN, 7, NMELS)))
    logits = logits.transpose(0, 1, 3, 2).reshape(N_WIN * WIN, 648, 14)[:t]
    want = logits.argmax(-1)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert got.shape == want.shape == (t, 648)
    assert len(np.unique(want)) > 3  # many classes, not one
    np.testing.assert_array_equal(got[clear], want[clear])
    shutil.rmtree(tmp_path, ignore_errors=True)  # a 0.13 GB checkpoint
