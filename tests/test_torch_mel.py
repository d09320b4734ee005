"""The port's log-mel front-end against seld_tpu's: kernel K1's plain
version (the arithmetic the CUDA kernel does, run on the CPU) against the
Pallas kernel in interpret mode and the rFFT oracle, and the corpus
entry point against seld_tpu.data.corpus.compute_mel_features; the
spatial feature sets route to K4 (tests/test_torch_spatial.py holds K4)."""

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
from seld_tpu_torch.ops.mel_cuda import log_mel_frames, log_mel_frames_reference
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

