"""Kernel K1 and the port's CUDA guards, on an NVIDIA card.

This file imports neither JAX nor seld_tpu, so it runs where only PyTorch
is installed; the repo's conftest.py needs JAX, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips.
"""

import pytest
import torch

from seld_tpu_torch import no_tf32
from seld_tpu_torch.ops.attention import FLASH_MIN_SEQ_LEN, multi_head_attention
from seld_tpu_torch.ops.mel_cuda import log_mel_frames, log_mel_frames_reference

pytestmark = pytest.mark.cuda

NFFT = 960
# float32 FMA in the kernel's order against cuBLAS's float32 GEMMs; the
# JAX package holds its mel kernel to the same 5e-3 dB
DB_ATOL = 5e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with no_tf32():  # the plain version in true f32
        yield torch.device("cuda")


@pytest.mark.parametrize("n", [1, 37, 12_004])
def test_k1_matches_plain_on_card(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(n)
    frames = torch.randn((n, NFFT), generator=g, device=cuda_device)
    before = log_mel_frames.launches
    got = log_mel_frames(frames)
    torch.cuda.synchronize()
    assert log_mel_frames.launches == before + 1
    assert got.shape == (n, 64)
    torch.testing.assert_close(got, log_mel_frames_reference(frames), atol=DB_ATOL, rtol=0)


def test_k1_silence_on_card(cuda_device):
    got = log_mel_frames(torch.zeros((8, NFFT), device=cuda_device))
    torch.testing.assert_close(got, torch.full_like(got, -100.0), atol=1e-4, rtol=0)


def test_k1_fewer_mels_on_card(cuda_device):
    frames = torch.randn((100, NFFT), device=cuda_device)
    got = log_mel_frames(frames, n_mels=40)
    assert got.shape == (100, 40)
    torch.testing.assert_close(got, log_mel_frames_reference(frames, n_mels=40),
                               atol=DB_ATOL, rtol=0)


@pytest.mark.parametrize("make,err", [
    (lambda d: torch.zeros((8, NFFT), dtype=torch.float64, device=d), TypeError),
    (lambda d: torch.zeros((8, 2 * NFFT), device=d)[:, ::2], ValueError),
    (lambda d: torch.zeros((8 * NFFT + 1,), device=d)[1:].view(8, NFFT), ValueError),
])
def test_k1_rejects_what_it_cannot_take(cuda_device, make, err):
    before = log_mel_frames.launches
    with pytest.raises(err):
        log_mel_frames(make(cuda_device))
    assert log_mel_frames.launches == before


def test_attention_at_flash_length_names_k3(cuda_device):
    q = torch.zeros((1, 1, FLASH_MIN_SEQ_LEN, 64), device=cuda_device)
    with pytest.raises(NotImplementedError, match="K3"):
        multi_head_attention(q, q, q)
