"""Kernels K1 and K2 and the port's CUDA guards, on an NVIDIA card.

This file imports neither JAX nor seld_tpu, so it runs where only PyTorch
is installed; the repo's conftest.py needs JAX, so skip it there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips.
"""

import pytest
import torch

from seld_tpu_torch import no_tf32
from seld_tpu_torch.config import GridConfig, LossConfig
from seld_tpu_torch.losses import SELDLossFn
from seld_tpu_torch.ops.attention import FLASH_MIN_SEQ_LEN, multi_head_attention
from seld_tpu_torch.ops.loss_cuda import grid_loss_terms, grid_loss_terms_reference
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


M, G = 14, 648


def _k2_case(device, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = 3.0 * torch.randn((n, M, G), generator=g, device=device)
    bits = torch.randint(1, 2 ** (M - 1), (n, G), generator=g, device=device)
    keep = torch.rand((n, G), generator=g, device=device) >= 0.9
    mask = torch.where(keep, bits, torch.zeros_like(bits)).to(torch.int16)
    w = torch.randn((2, n, G), generator=g, device=device)
    return x, mask, w


@pytest.mark.parametrize("n", [1, 37, 4000])
def test_k2_matches_plain_on_card(cuda_device, n):
    """Forward rtol 1e-5, gradient rtol 2e-4 (float32 exp and sums in
    another order), with a cotangent on both outputs and on sq alone."""
    x, mask, w = _k2_case(cuda_device, n, seed=n)
    before = (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches)
    results = []
    for terms in (grid_loss_terms, grid_loss_terms_reference):
        xg = x.clone().requires_grad_(True)
        sq, pbg = terms(xg, mask, M)
        (both,) = torch.autograd.grad((sq, pbg), xg, (w[0], w[1]), retain_graph=True)
        (sq_only,) = torch.autograd.grad(sq.sum(), xg)  # p_bg's cotangent is None
        results.append((sq.detach(), pbg.detach(), both, sq_only))
    torch.cuda.synchronize()
    assert (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches) == (
        before[0] + 1, before[1] + 2)
    got, want = results
    assert got[0].shape == got[1].shape == (n, G)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], rtol=2e-4, atol=1e-6)


def test_k2_fewer_classes_and_no_grad_on_card(cuda_device):
    x, mask, _ = _k2_case(cuda_device, 50, seed=3)
    x5 = x[:, :5].contiguous()
    mask5 = mask & 0b1111
    with torch.no_grad():
        sq, pbg = grid_loss_terms(x5, mask5, 5)
    assert not sq.requires_grad
    want_sq, want_pbg = grid_loss_terms_reference(x5, mask5, 5)
    torch.testing.assert_close(sq, want_sq, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(pbg, want_pbg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("make,err", [
    (lambda x, m: (x.bfloat16(), m, M), TypeError),
    (lambda x, m: (x.transpose(0, 1).contiguous().transpose(0, 1), m, M), ValueError),
    (lambda x, m: (x, m.float(), M), TypeError),
    (lambda x, m: (x, m.cpu(), M), ValueError),
    (lambda x, m: (torch.zeros((4, 17, G), device=x.device), m[:4], 17), ValueError),
])
def test_k2_rejects_what_it_cannot_take(cuda_device, make, err):
    x, mask, _ = _k2_case(cuda_device, 8, seed=4)
    before = (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches)
    with pytest.raises(err):
        grid_loss_terms(*make(x, mask))
    assert (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches) == before


def test_loss_auto_goes_through_k2_on_card_and_fused_true_needs_it(cuda_device):
    x, mask, _ = _k2_case(cuda_device, 2 * 5, seed=5)
    logits = x.reshape(2, 5, M, G).requires_grad_(True)
    em = torch.tensor([1.0, 0.0], device=cuda_device)
    for cfg in (LossConfig(), LossConfig(use_aiur=True, use_cl=True)):
        fn = SELDLossFn(cfg, GridConfig())
        before = (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches)
        auto = fn.from_bitmask(logits, mask.reshape(2, 5, G), em)
        (g_auto,) = torch.autograd.grad(auto.total, logits)
        assert (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches) == (
            before[0] + 1, before[1] + 1)
        plain = fn.from_bitmask(logits, mask.reshape(2, 5, G), em, fused=False)
        (g_plain,) = torch.autograd.grad(plain.total, logits)
        assert (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches) == (
            before[0] + 1, before[1] + 1)  # fused=False launched nothing
        torch.testing.assert_close(auto.total, plain.total, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(g_auto, g_plain, rtol=2e-4, atol=1e-9)
    with pytest.raises(ValueError, match="CUDA"):
        fn.from_bitmask(logits.detach().cpu(), mask.reshape(2, 5, G).cpu(), fused=True)
