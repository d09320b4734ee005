"""Kernels K1-K5 and the port's CUDA guards, on an NVIDIA card.

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
from seld_tpu_torch.ops.attention import (
    FLASH_MIN_SEQ_LEN,
    force_flash,
    multi_head_attention,
)
from seld_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    launch_dkv,
    launch_dq,
    launch_forward,
    row_delta,
)
from seld_tpu_torch.ops.loss_cuda import grid_loss_terms, grid_loss_terms_reference
from seld_tpu_torch.features.mel import frame_signal
from seld_tpu_torch.ops.mel_cuda import KERNEL_N_FFT, log_mel_frames, log_mel_frames_reference
from seld_tpu_torch.ops.spatial_cuda import spatial_features, spatial_features_reference

pytestmark = pytest.mark.cuda

NFFT = 960
# a float32 FFT against cuBLAS's float32 DFT GEMMs; the JAX package holds
# its mel kernel to the same 5e-3 dB
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


@pytest.mark.parametrize("t", [3001, 37])
def test_k1_reads_the_padded_waveform_in_place_on_card(cuda_device, t):
    """frame_signal's (4, T, n_fft) view of the reflect-padded waveform
    (hop n_fft / 2): one launch, no copy, the plain version's numbers on
    the contiguous copy of the same frames."""
    g = torch.Generator(device=cuda_device).manual_seed(t)
    wave = 0.1 * torch.randn((4, (t - 1) * (NFFT // 2)), generator=g, device=cuda_device)
    view = frame_signal(wave, NFFT, NFFT // 2)
    assert view.shape == (4, t, NFFT) and not view.is_contiguous()
    before = log_mel_frames.launches
    got = log_mel_frames(view)
    torch.cuda.synchronize()
    assert log_mel_frames.launches == before + 1
    want = log_mel_frames_reference(view.reshape(-1, NFFT)).reshape(4, t, 64)
    torch.testing.assert_close(got, want, atol=DB_ATOL, rtol=0)


def test_k1_reads_unaligned_views_on_card(cuda_device):
    """Odd strides and an odd start take the kernel's scalar loads."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    flat = torch.randn((3 * 9_001,), generator=g, device=cuda_device)[1:]
    view = flat.as_strided((3, 17, NFFT), (9_001, 479, 1))
    got = log_mel_frames(view)
    want = log_mel_frames_reference(view.reshape(-1, NFFT)).reshape(3, 17, 64)
    torch.testing.assert_close(got, want, atol=DB_ATOL, rtol=0)


@pytest.mark.parametrize("n_fft", KERNEL_N_FFT)
def test_k1_every_n_fft_on_card(cuda_device, n_fft):
    g = torch.Generator(device=cuda_device).manual_seed(n_fft)
    frames = torch.randn((300, n_fft), generator=g, device=cuda_device)
    got = log_mel_frames(frames, n_fft=n_fft)
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


@pytest.mark.parametrize("make,n_fft,err", [
    (lambda d: torch.zeros((8, NFFT), dtype=torch.float64, device=d), NFFT, TypeError),
    (lambda d: torch.zeros((8, 2 * NFFT), device=d)[:, ::2], NFFT, ValueError),
    (lambda d: torch.zeros((8, 0), device=d), 0, ValueError),  # no frame at all
    (lambda d: torch.zeros((2, 2, 8, NFFT), device=d), NFFT, ValueError),
])
def test_k1_rejects_what_it_cannot_take(cuda_device, make, n_fft, err):
    before = log_mel_frames.launches
    with pytest.raises(err):
        log_mel_frames(make(cuda_device), n_fft=n_fft)
    assert log_mel_frames.launches == before


def _k1_counts():
    return (log_mel_frames.launches, log_mel_frames.mixed_launches, log_mel_frames.dft_launches)


def _k1_other_n_fft(device, n_fft, want):
    """K1 at an n_fft outside KERNEL_N_FFT, contiguous and on frame_signal's
    view: the launch counts (FFT, mixed-radix, DFT tiles) move by `want`,
    and the output is the plain version's."""
    g = torch.Generator(device=device).manual_seed(n_fft)
    frames = torch.randn((300, n_fft), generator=g, device=device)
    wave = 0.1 * torch.randn((2, 40 * 480), generator=g, device=device)
    view = frame_signal(wave, n_fft, 480)
    before = _k1_counts()
    got, got_v = log_mel_frames(frames, n_fft=n_fft), log_mel_frames(view, n_fft=n_fft)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_k1_counts(), before)) == want
    torch.testing.assert_close(got, log_mel_frames_reference(frames), atol=DB_ATOL, rtol=0)
    torch.testing.assert_close(got_v, log_mel_frames_reference(
        view.reshape(-1, n_fft)).reshape(got_v.shape), atol=DB_ATOL, rtol=0)


@pytest.mark.parametrize("n_fft", [17, 1202])
def test_k1_dft_path_every_other_n_fft_on_card(cuda_device, n_fft):
    """An n_fft neither FFT kernel takes (odd; 1202 = 2 x 601) goes through
    the DFT tiles."""
    _k1_other_n_fft(cuda_device, n_fft, (0, 0, 2))


@pytest.mark.parametrize("n_fft", [1200, 600, 640, 882, 1764, 1920])
def test_k1_mixed_path_on_card(cuda_device, n_fft):
    """An even n_fft with a 7-smooth half goes through the mixed-radix
    kernel, once a call (882: an odd M = 441)."""
    _k1_other_n_fft(cuda_device, n_fft, (0, 2, 0))


def _k3_launches():
    return (flash_attention.fwd_launches, flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches)


def _k3_case(device, b, h, t, dh, dtype, seed, key_scale=1.0):
    """q, k, v as the model makes them: (B, T, H*Dh) projections viewed as
    (B, H, T, Dh), so time and head strides are swapped; and a cotangent."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = [torch.randn((b, t, h * dh), generator=g, device=device).to(dtype)
           .view(b, t, h, dh).transpose(1, 2) for _ in range(3)]
    qkv[1] = qkv[1] * key_scale
    w = torch.randn((b, h, t, dh), generator=g, device=device).to(dtype)
    return (*qkv, w)


def _attend(fn, q, k, v, w):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out, lse = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), w)
    return (out.detach(), lse.detach(), *grads)


@pytest.mark.parametrize("b,h,t,dh", [
    (1, 2, 64, 64), (2, 2, 130, 64), (1, 3, 513, 64), (2, 1, 130, 32), (1, 2, 200, 128),
    (1, 1, 77, 16), (16, 8, 1000, 64),
])
def test_k3_float32_matches_plain_on_card(cuda_device, b, h, t, dh):
    """The JAX kernel tests' own tolerances: forward atol 2e-5, lse 1e-5,
    gradients rtol 2e-4 / atol 2e-5 (float32 sums in another order)."""
    q, k, v, w = _k3_case(cuda_device, b, h, t, dh, torch.float32, seed=t)
    before = _k3_launches()
    got = _attend(lambda *a: flash_attention(*a, return_lse=True), q, k, v, w)
    torch.cuda.synchronize()
    assert _k3_launches() == tuple(n + 1 for n in before)
    want = _attend(flash_attention_reference, q, k, v, w)
    assert got[0].shape == (b, h, t, dh) and got[1].shape == (b * h, t)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-5)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    for a, r in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, r, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("b,h,t,dh", [
    (1, 2, 64, 64), (2, 2, 130, 64), (1, 3, 513, 64), (2, 1, 130, 32), (1, 2, 200, 128),
    (16, 8, 1000, 64),
])
def test_k3_bfloat16_is_as_close_to_float32_as_plain_bfloat16(cuda_device, b, h, t, dh):
    """bf16: the kernel's largest error against the float32 plain version
    on the same bf16-rounded inputs is at most 1.5 times the bf16 plain
    version's own (both round the probabilities, ds and the outputs to
    bf16)."""
    q, k, v, w = _k3_case(cuda_device, b, h, t, dh, torch.bfloat16, seed=t)
    got = _attend(lambda *a: flash_attention(*a, return_lse=True), q, k, v, w)
    plain = _attend(flash_attention_reference, q, k, v, w)
    exact = _attend(flash_attention_reference, *(x.float() for x in (q, k, v, w)))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    torch.testing.assert_close(got[1], exact[1], rtol=0, atol=1e-4)
    for name, i in (("out", 0), ("dq", 2), ("dk", 3), ("dv", 4)):
        err = (got[i].float() - exact[i]).abs().max().item()
        plain_err = (plain[i].float() - exact[i]).abs().max().item()
        assert err <= 1.5 * plain_err + 1e-6, (name, err, plain_err)


def test_k3_gives_no_weight_to_padded_keys_on_card(cuda_device):
    """Keys ten times larger sharpen the softmax; a padded key that leaked
    in would show (tests/test_pallas_kernels.py holds the TPU kernel to the
    same 5e-5)."""
    q, k, v, w = _k3_case(cuda_device, 1, 2, 130, 64, torch.float32, seed=9, key_scale=10.0)
    got = flash_attention(q, k, v)
    want, _ = flash_attention_reference(q, k, v)
    torch.testing.assert_close(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_backward_is_bit_reproducible_on_card(cuda_device, dtype):
    q, k, v, w = _k3_case(cuda_device, 2, 4, 700, 64, dtype, seed=11)
    first = _attend(lambda *a: flash_attention(*a, return_lse=True), q, k, v, w)
    second = _attend(lambda *a: flash_attention(*a, return_lse=True), q, k, v, w)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("t", [37, 64, 513, 1000])
@pytest.mark.parametrize("dh", [32, 48, 64, 80, 128])
def test_k3_wgmma_backward_every_width_is_as_close_as_plain_bfloat16(cuda_device, t, dh):
    """The wgmma dQ and dK/dV kernels at head widths below, at and above one
    64-column box, ragged T included: each gradient within 1.5 times the
    bf16 plain version's error against float32 (32 heads, so that the
    largest error is not one value's chance)."""
    q, k, v, w = _k3_case(cuda_device, 4, 8, t, dh, torch.bfloat16, seed=t + dh)
    got = _attend(lambda *a: flash_attention(*a, return_lse=True), q, k, v, w)
    plain = _attend(flash_attention_reference, q, k, v, w)
    exact = _attend(flash_attention_reference, *(x.float() for x in (q, k, v, w)))
    for name, i in (("dq", 2), ("dk", 3), ("dv", 4)):
        err = (got[i].float() - exact[i]).abs().max().item()
        plain_err = (plain[i].float() - exact[i]).abs().max().item()
        assert err <= 1.5 * plain_err + 1e-6, (name, err, plain_err)


def _forward_errors(q, k, v):
    """The bf16 forward's out error against the float32 plain version, the
    bf16 plain version's, and lse's error against float32's."""
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, return_lse=True)
        plain, _ = flash_attention_reference(q, k, v)
        exact, exact_lse = flash_attention_reference(q.float(), k.float(), v.float())
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    return ((out.float() - exact).abs().max().item(), (plain.float() - exact).abs().max().item(),
            (lse - exact_lse).abs().max().item())


@pytest.mark.parametrize("t", [37, 64, 130, 513, 1000])
@pytest.mark.parametrize("dh", [16, 32, 48, 64, 80, 128])
def test_k3_wgmma_forward_every_width_is_as_close_as_plain_bfloat16(cuda_device, t, dh):
    """The wgmma forward at head widths below, at and above one 64-column
    box (K/V tiles of 128 keys up to Dh = 64, 64 above), ragged T included:
    out within 1.5 times the bf16 plain version's error against float32,
    lse within 1e-4 of float32's (32 heads)."""
    q, k, v, _ = _k3_case(cuda_device, 4, 8, t, dh, torch.bfloat16, seed=t + dh)
    err, plain_err, lse_err = _forward_errors(q, k, v)
    assert err <= 1.5 * plain_err + 1e-6, (err, plain_err)
    assert lse_err <= 1e-4, lse_err


@pytest.mark.parametrize("dh", [64, 128])
def test_k3_wgmma_forward_gives_no_weight_to_padded_keys(cuda_device, dh):
    """Keys ten times larger sharpen the softmax, so a padded key of the
    ragged last tile that leaked in would show (T = 130: the last tile's
    64 keys hold 2); lse within 10 x 1e-4."""
    q, k, v, _ = _k3_case(cuda_device, 4, 8, 130, dh, torch.bfloat16, seed=31, key_scale=10.0)
    err, plain_err, lse_err = _forward_errors(q, k, v)
    assert err <= 1.5 * plain_err + 1e-6, (err, plain_err)
    assert lse_err <= 1e-3, lse_err


def test_k3_wgmma_forward_is_bit_reproducible_on_card(cuda_device):
    q, k, v, _ = _k3_case(cuda_device, 16, 8, 1000, 64, torch.bfloat16, seed=32)
    with torch.no_grad():
        first = flash_attention(q, k, v, return_lse=True)
        second = flash_attention(q, k, v, return_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_k3_forward_is_one_wgmma_launch_on_card(cuda_device):
    """A bf16 forward is one launch of the wgmma forward kernel and nothing
    else on the card: no copy of the model's strided q, k, v, no
    transposition of out (counters and the profiler's kernel names)."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, _ = _k3_case(cuda_device, 2, 8, 1000, 64, torch.bfloat16, seed=33)
    assert not q.is_contiguous()
    flash_attention(q, k, v)
    torch.cuda.synchronize()
    before, copies = _k3_launches(), flash_attention.copies
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
    assert _k3_launches() == (before[0] + 1, before[1], before[2])
    assert flash_attention.copies == copies
    assert out.transpose(1, 2).is_contiguous()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    assert len(names) == 1 and "flash_fwd_wgmma_kernel" in names[0], names


def test_k3_wgmma_forward_reads_the_models_layout_in_place(cuda_device):
    """q, k, v as the model's projections make them and the same values
    made contiguous give the same bits, with no copy counted for either."""
    q, k, v, _ = _k3_case(cuda_device, 2, 4, 513, 64, torch.bfloat16, seed=34)
    copies = flash_attention.copies
    with torch.no_grad():
        strided = flash_attention(q, k, v, return_lse=True)
        packed = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), return_lse=True)
    assert flash_attention.copies == copies
    assert all(torch.equal(a, b) for a, b in zip(strided, packed))


def test_k3_dq_kernel_writes_delta_and_takes_a_given_one(cuda_device):
    """delta = rowsum(dO * out) in float32, formed by the dQ kernel: within
    1e-5 of row_delta relative to rowsum(|dO * out|) (the same float32
    products summed in another order). Given row_delta's delta the kernel
    reads it, and dq moves by no more than a bf16 rounding step or two."""
    q, k, v, w = _k3_case(cuda_device, 16, 8, 1000, 64, torch.bfloat16, seed=21)
    scale = 64 ** -0.5
    with torch.no_grad():
        out, lse = launch_forward(q, k, v, scale)
        dq, delta = launch_dq(q, k, v, w, out, lse, scale)
        want = row_delta(w, out).view(delta.shape)
        size = (w.float() * out.float()).abs().sum(-1).view(delta.shape)
        assert ((delta - want).abs() <= 1e-5 * size).all()
        dq_given, same = launch_dq(q, k, v, w, out, lse, scale, delta=want)
        assert same is want
        torch.testing.assert_close(dq_given, dq, rtol=2 ** -6, atol=1e-3)
        dk, dv = launch_dkv(q, k, v, w, lse, delta, scale)
        torch.cuda.synchronize()
    assert torch.isfinite(dk.float()).all() and torch.isfinite(dv.float()).all()


def test_k3_backward_is_one_dq_and_one_dkv_launch_on_card(cuda_device):
    """A bf16 backward launches the dQ kernel, then the dK/dV kernel, and no
    kernel between them: no delta ops (counters and the profiler's kernel
    names)."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, w = _k3_case(cuda_device, 2, 8, 1000, 64, torch.bfloat16, seed=22)
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    before = _k3_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(out, (q, k, v), w)
        torch.cuda.synchronize()
    assert _k3_launches() == (before[0], before[1] + 1, before[2] + 1)
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation), key=lambda e: e.time_range.start)
    names = [e.name for e in kernels]
    dq = [i for i, n in enumerate(names) if "flash_dq_wgmma_kernel" in n]
    dkv = [i for i, n in enumerate(names) if "flash_dkv_wgmma_kernel" in n]
    assert len(dq) == 1 and dkv == [dq[0] + 1], names


def test_k3_gradients_of_k_and_v_alone_on_card(cuda_device):
    """q without a gradient: the dQ pass is skipped (delta from row_delta)
    and dk, dv are those of the full backward, bit for bit."""
    q, k, v, w = _k3_case(cuda_device, 2, 4, 513, 64, torch.bfloat16, seed=23)
    full = _attend(lambda *a: flash_attention(*a, return_lse=True), q, k, v, w)
    kk, vv = (x.detach().clone().requires_grad_(True) for x in (k, v))
    before = _k3_launches()
    dk, dv = torch.autograd.grad(flash_attention(q, kk, vv), (kk, vv), w)
    assert _k3_launches() == (before[0] + 1, before[1], before[2] + 1)
    # row_delta sums in another order than the kernel: a ds or a stored dk
    # may round to the neighbouring bf16 value (2^-7 relative)
    torch.testing.assert_close(dk, full[3], rtol=2 ** -6, atol=1e-3)
    assert torch.equal(dv, full[4])  # dv does not read delta


def test_k3_bf16_backward_is_bit_reproducible_at_t_1000_on_card(cuda_device):
    q, k, v, w = _k3_case(cuda_device, 16, 8, 1000, 64, torch.bfloat16, seed=24)
    first = _attend(lambda *a: flash_attention(*a, return_lse=True), q, k, v, w)
    second = _attend(lambda *a: flash_attention(*a, return_lse=True), q, k, v, w)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_k3_reads_strided_inputs_in_place_and_copies_what_it_must(cuda_device):
    q, k, v, w = _k3_case(cuda_device, 2, 2, 130, 64, torch.float32, seed=12)
    assert not q.is_contiguous()
    copies = flash_attention.copies
    out = flash_attention(q, k, v)
    assert flash_attention.copies == copies  # the model's layout: no copy
    assert out.transpose(1, 2).is_contiguous()  # (B, T, H, Dh): the reshape after is a view
    odd = torch.zeros((2, 2, 130, 65), device=cuda_device)[..., 1:]  # misaligned rows
    odd.copy_(q)
    torch.testing.assert_close(flash_attention(odd, k, v), out, rtol=0, atol=0)
    assert flash_attention.copies == copies + 1
    leaf = q.detach().clone().requires_grad_(True)
    flash_attention(leaf, k, v).sum().backward()  # sum's cotangent is expanded: stride 0
    assert flash_attention.copies == copies + 2
    want = q.detach().clone().requires_grad_(True)
    flash_attention_reference(want, k, v)[0].sum().backward()
    torch.testing.assert_close(leaf.grad, want.grad, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("make,err", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), TypeError),
    (lambda q, k, v: (q, k.bfloat16(), v), TypeError),
    (lambda q, k, v: (q[..., :24], k[..., :24], v[..., :24]), ValueError),
    (lambda q, k, v: (q, k.cpu(), v), ValueError),
    (lambda q, k, v: (q, k[:, :, :-1], v), ValueError),
    (lambda q, k, v: (q[0], k[0], v[0]), ValueError),
])
def test_k3_rejects_what_it_cannot_take(cuda_device, make, err):
    q, k, v, _ = _k3_case(cuda_device, 1, 2, 64, 64, torch.float32, seed=13)
    before = _k3_launches()
    with pytest.raises(err):
        flash_attention(*make(q, k, v))
    assert _k3_launches() == before


def test_attention_at_flash_length_launches_k3(cuda_device):
    """T >= 512 on CUDA goes through K3; below it, and under
    force_flash(False), the plain product; force_flash(True) takes K3 at
    any length and refuses a CPU tensor."""
    q, k, v, _ = _k3_case(cuda_device, 1, 2, FLASH_MIN_SEQ_LEN, 64, torch.float32, seed=14)
    before = flash_attention.fwd_launches
    long = multi_head_attention(q, k, v)
    assert flash_attention.fwd_launches == before + 1
    with force_flash(False):
        plain = multi_head_attention(q, k, v)
    short = multi_head_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100])
    assert flash_attention.fwd_launches == before + 1
    torch.testing.assert_close(long, plain, rtol=0, atol=2e-5)
    with force_flash(True):
        forced = multi_head_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100])
        assert flash_attention.fwd_launches == before + 2
        with pytest.raises(ValueError, match="CUDA"):
            multi_head_attention(q.cpu(), k.cpu(), v.cpu())
    torch.testing.assert_close(forced, short, rtol=0, atol=2e-5)


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


# K4 against its plain version: float32 FFTs against cuBLAS's float32 DFT
# GEMMs. The JAX package holds its spatial kernel to 5e-3 dB on the mel
# planes and 1e-4 on the IV and GCC planes.
K4_SETS = ("mel", "mel_iv", "mel_gcc")
K4_PLANES = {"mel": 4, "mel_iv": 7, "mel_gcc": 10}


def _k4_check(got, want):
    torch.testing.assert_close(got[:, :4], want[:, :4], atol=DB_ATOL, rtol=0)
    torch.testing.assert_close(got[:, 4:], want[:, 4:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("feature_set", K4_SETS)
@pytest.mark.parametrize("t", [1, 37, 3001])
def test_k4_matches_plain_on_card(cuda_device, feature_set, t):
    g = torch.Generator(device=cuda_device).manual_seed(t)
    frames = torch.randn((4, t, NFFT), generator=g, device=cuda_device)
    before = spatial_features.launches
    got = spatial_features(frames, feature_set)
    torch.cuda.synchronize()
    assert spatial_features.launches == before + 1
    assert got.shape == (t, {"mel": 4, "mel_iv": 7, "mel_gcc": 10}[feature_set], 64)
    _k4_check(got, spatial_features_reference(frames, feature_set))


@pytest.mark.parametrize("feature_set", K4_SETS)
def test_k4_silence_is_finite_on_card(cuda_device, feature_set):
    got = spatial_features(torch.zeros((4, 20, NFFT), device=cuda_device), feature_set)
    torch.testing.assert_close(got[:, :4], torch.full_like(got[:, :4], -100.0),
                               atol=1e-4, rtol=0)
    assert torch.equal(got[:, 4:], torch.zeros_like(got[:, 4:]))


def test_k4_chunks_long_inputs_and_fewer_mels_on_card(cuda_device):
    """Any length is one launch (the earlier GEMM kernel took 16,384
    frames a launch); fewer mels on a contiguous slice."""
    t = (1 << 14) + 5
    frames = torch.randn((4, t, NFFT), device=cuda_device)
    before = spatial_features.launches
    got = spatial_features(frames, "mel_gcc")
    assert spatial_features.launches == before + 1
    _k4_check(got, spatial_features_reference(frames, "mel_gcc"))
    small = frames[:, :50].contiguous()
    _k4_check(spatial_features(small, "mel_iv", n_mels=40),
              spatial_features_reference(small, "mel_iv", n_mels=40))


def test_k4_is_bit_reproducible_on_card(cuda_device):
    """No atomics: reruns are bit-equal, on contiguous frames and on
    frame_signal's in-place view."""
    frames = torch.randn((4, 300, NFFT), device=cuda_device)
    view = _k4_view(300, NFFT, 300)
    for feature_set in K4_SETS:
        for x in (frames, view):
            assert torch.equal(spatial_features(x, feature_set),
                               spatial_features(x, feature_set))


@pytest.mark.parametrize("make,err", [
    (lambda d: torch.zeros((4, 8, NFFT), dtype=torch.float64, device=d), TypeError),
    (lambda d: torch.zeros((4, 8, 2 * NFFT), device=d)[..., ::2], ValueError),
    (lambda d: torch.zeros((3, 8, NFFT), device=d), ValueError),
    (lambda d: torch.zeros((4, 8, 0), device=d), ValueError),
])
def test_k4_rejects_what_it_cannot_take(cuda_device, make, err):
    """Raised before any launch: the wrong dtype, a column stride other
    than 1, a channel count other than 4, an n_fft of 0 (every n_fft from 1
    on is taken: fault F2), an unknown feature set and more than 64 mels."""
    before = spatial_features.launches
    with pytest.raises(err):
        spatial_features(make(cuda_device), "mel_iv")
    with pytest.raises(ValueError, match="feature_set"):
        spatial_features(torch.zeros((4, 8, NFFT), device=cuda_device), "mel_xyz")
    with pytest.raises(ValueError, match="at most 64"):
        spatial_features(torch.zeros((4, 8, NFFT), device=cuda_device), "mel", n_mels=65)
    assert spatial_features.launches == before


def _k4_view(t, n_fft, seed):
    """frame_signal's (4, T, n_fft) view of a reflect-padded seeded clip."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    wave = 0.1 * torch.randn((4, (t - 1) * (n_fft // 2)), generator=g, device="cuda")
    view = frame_signal(wave, n_fft, n_fft // 2)
    assert view.shape == (4, t, n_fft) and not view.is_contiguous()
    return view


@pytest.mark.parametrize("feature_set", K4_SETS)
@pytest.mark.parametrize("t", [3001, 37])
def test_k4_reads_the_padded_waveform_in_place_on_card(cuda_device, feature_set, t):
    """One launch on the view, no copy; the plain version's numbers on the
    contiguous copy of the same frames."""
    view = _k4_view(t, NFFT, t)
    before = spatial_features.launches
    got = spatial_features(view, feature_set)
    torch.cuda.synchronize()
    assert spatial_features.launches == before + 1
    assert got.shape == (t, K4_PLANES[feature_set], 64)
    _k4_check(got, spatial_features_reference(view.contiguous(), feature_set))


@pytest.mark.parametrize("feature_set", K4_SETS)
@pytest.mark.parametrize("n_fft", KERNEL_N_FFT)
def test_k4_every_n_fft_on_card(cuda_device, n_fft, feature_set):
    view = _k4_view(300, n_fft, n_fft)
    _k4_check(spatial_features(view, feature_set),
              spatial_features_reference(view.contiguous(), feature_set))


def _k4_counts():
    return (spatial_features.launches, spatial_features.mixed_launches,
            spatial_features.dft_launches)


def _k4_other_n_fft(n_fft, feature_set, want):
    """K4 at an n_fft outside KERNEL_N_FFT on frame_signal's view and on its
    contiguous copy: the launch counts (FFT, mixed-radix, DFT tiles) move by
    `want`, and the output is the plain version's, at the JAX package's bars."""
    view = _k4_view(61, n_fft, n_fft)
    contiguous = view.contiguous()
    before = _k4_counts()
    got, got_c = spatial_features(view, feature_set), spatial_features(contiguous, feature_set)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_k4_counts(), before)) == want
    want_out = spatial_features_reference(contiguous, feature_set)
    _k4_check(got, want_out)
    _k4_check(got_c, want_out)


@pytest.mark.parametrize("feature_set", K4_SETS)
@pytest.mark.parametrize("n_fft", [17, 1202])
def test_k4_dft_path_every_other_n_fft_on_card(cuda_device, n_fft, feature_set):
    """An n_fft neither FFT kernel takes goes through the DFT tiles."""
    _k4_other_n_fft(n_fft, feature_set, (0, 0, 2))


@pytest.mark.parametrize("feature_set", K4_SETS)
@pytest.mark.parametrize("n_fft", [1200, 600, 640, 882, 1764, 1920])
def test_k4_mixed_path_on_card(cuda_device, n_fft, feature_set):
    """An even n_fft with a 7-smooth half goes through the mixed-radix
    kernel, once a call; silence gives -100 dB and exact zeros."""
    _k4_other_n_fft(n_fft, feature_set, (0, 2, 0))
    quiet = spatial_features(torch.zeros((4, 5, n_fft), device="cuda"), feature_set)
    assert (quiet[:, :4] + 100.0).abs().max().item() <= 1e-4 and not quiet[:, 4:].any()


@pytest.mark.parametrize("feature_set", K4_SETS)
def test_k4_fewer_mels_in_place_on_card(cuda_device, feature_set):
    view = _k4_view(200, NFFT, 40)
    got = spatial_features(view, feature_set, n_mels=40)
    assert got.shape == (200, K4_PLANES[feature_set], 40)
    _k4_check(got, spatial_features_reference(view.contiguous(), feature_set, n_mels=40))


def test_k4_reads_unaligned_views_on_card(cuda_device):
    """Odd strides and an odd start take the kernel's scalar loads."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    flat = torch.randn((4 * 9_001,), generator=g, device=cuda_device)[1:]
    view = flat.as_strided((4, 17, NFFT), (9_001, 479, 1))
    for feature_set in K4_SETS:
        _k4_check(spatial_features(view, feature_set),
                  spatial_features_reference(view.contiguous(), feature_set))


def test_k4_mel_planes_equal_k1_on_card(cuda_device):
    """K4's mel planes run K1's FFT stage and band loop on the same
    weights in the same order: K1's output, bit for bit."""
    view = _k4_view(3001, NFFT, 9)
    k1 = log_mel_frames(view).transpose(0, 1)  # (T, 4, 64)
    for feature_set in K4_SETS:
        assert torch.equal(spatial_features(view, feature_set)[:, :4], k1)


def test_k4_commutes_with_acs_on_card(cuda_device):
    """Each channel goes through the same arithmetic, so a signed
    permutation of the audio channels permutes and signs K4's planes:
    audio-side transform then K4 equals K4 then the feature-side one."""
    from seld_tpu_torch.features.acs import N_TRANSFORMS, acs_tables, audio_channel_transform

    frames = torch.randn((4, 200, NFFT), device=cuda_device)
    _, ch_perm, ch_sign = acs_tables(18, 36)
    base = spatial_features(frames, "mel_iv")
    for t in range(N_TRANSFORMS):
        perm, sign = audio_channel_transform(t)
        audio_t = (torch.from_numpy(sign).to(cuda_device)[:, None, None]
                   * frames[torch.from_numpy(perm).to(cuda_device)]).contiguous()
        got = (torch.from_numpy(ch_sign[t]).to(cuda_device)[None, :, None]
               * base[:, torch.from_numpy(ch_perm[t]).long().to(cuda_device)])
        torch.testing.assert_close(got, spatial_features(audio_t, "mel_iv"), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("feature_set", ["mel_iv", "mel_gcc"])
def test_spatial_features_of_a_clip_launch_k4_once_on_card(cuda_device, feature_set):
    import numpy as np

    from seld_tpu_torch.config import FeatureConfig
    from seld_tpu_torch.data.corpus import compute_mel_features

    wave = (0.1 * np.random.default_rng(0).standard_normal((4, 60 * 24_000))).astype(np.float32)
    before = (spatial_features.launches, log_mel_frames.launches)
    feats = compute_mel_features(wave, FeatureConfig(feature_set=feature_set), cuda_device)
    torch.cuda.synchronize()
    assert (spatial_features.launches, log_mel_frames.launches) == (before[0] + 1, before[1])
    assert feats.shape == (3001, 7 if feature_set == "mel_iv" else 10, 64)
    assert bool(torch.isfinite(feats).all())


# --- the other grid backbones, bf16 norms and remat on the card -----------

TINY_BACKBONES = {
    "crnn": ["model.model_type=crnn", "model.crnn_cnn_channels=8,16",
             "model.crnn_rnn_hidden=16"],
    "conformer": ["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                  "model.conf_d_model=64", "model.conf_n_heads=2"],
    "cnn": ["model.model_type=cnn"],
}


def _port_cfg(overrides):
    from seld_tpu_torch.config import Config, parse_overrides

    return parse_overrides(Config(), overrides)


def _step_once(cfg, model, mel, mask):
    from seld_tpu_torch.train.optimizer import make_optimizer
    from seld_tpu_torch.train.state import create_train_state
    from seld_tpu_torch.train.steps import make_train_step

    optimizer = make_optimizer(model.parameters(), 1e-3, 1e-4)
    step = make_train_step(model, SELDLossFn(cfg.loss, cfg.grid), optimizer,
                           cfg.grid.num_classes)
    return step(create_train_state(model, optimizer), mel, mask, None, (0, 1))[1]


@pytest.mark.parametrize("name", sorted(TINY_BACKBONES))
def test_backbone_trains_and_serves_on_card(cuda_device, name, tmp_path):
    """A bf16 train step (K2 forward and backward once each) and a 5 s
    predict from a saved checkpoint (K1 once) of each new backbone."""
    import numpy as np

    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    cfg = _port_cfg(TINY_BACKBONES[name])
    model = build_model(cfg.model, cfg.grid, device=cuda_device, seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mel = torch.randn((4, 50, 4, 64), device=cuda_device, generator=gen)
    mask = torch.randint(0, 2 ** 13, (4, 50, cfg.grid.n_cells), device=cuda_device,
                         generator=gen).to(torch.int16)
    grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
    metrics = _step_once(cfg, model, mel, mask)
    assert torch.isfinite(metrics["loss"])
    assert (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches) == (1, 1)
    save_checkpoint(tmp_path / "m.pt", model, cfg)
    pred = SELDPredictor(tmp_path / "m.pt", device=cuda_device)
    wave = (0.1 * np.random.default_rng(0).standard_normal((4, 5 * 24_000))).astype(np.float32)
    log_mel_frames.launches = 0
    classes = pred.predict_waveform(wave).classes
    assert log_mel_frames.launches == 1
    assert classes.shape == (251, cfg.grid.n_cells) and 0 <= classes.min()
    assert classes.max() < cfg.grid.num_classes


@pytest.mark.parametrize("train", [False, True])
def test_bf16_norms_on_card(cuda_device, train):
    """bf16 in, bf16 out, float32 statistics on CUDA: BatchNorm takes the
    float32 weights with a bf16 input; LayerNorm gets bf16 weights."""
    from seld_tpu_torch.models.layers import BatchNorm, LayerNorm

    x = torch.randn((4, 16, 50, 8), device=cuda_device).bfloat16()
    bn = BatchNorm(16, torch.bfloat16).to(cuda_device).train(train)
    ln = LayerNorm(8, torch.bfloat16).to(cuda_device)
    want = torch.nn.functional.batch_norm(x.float(), torch.zeros(16, device=cuda_device),
                                          torch.ones(16, device=cuda_device),
                                          training=train, eps=1e-5)
    got = bn(x)
    assert got.dtype == ln(x).dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-5)


@pytest.mark.parametrize("remat", ["resnet", "conformer", "all"])
def test_remat_matches_plain_on_card(cuda_device, remat):
    """The small float32 flagship at T = 512 (attention through K3) in train
    mode with dropout: remat against none, outputs within 1e-5, gradients
    within 1e-4, the statistics updated once; K3's forward launches once
    more per checkpointed conformer block."""
    from seld_tpu_torch.models import build_model

    base = ["model.resnet_conf_d_model=64", "model.resnet_conf_n_heads=2",
            "model.resnet_conf_n_layers=1", "model.compute_dtype=float32"]
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((1, FLASH_MIN_SEQ_LEN, 4, 64), device=cuda_device, generator=gen)
    w = torch.randn((1, FLASH_MIN_SEQ_LEN, 14, 648), device=cuda_device, generator=gen)
    runs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for r in ("none", remat):
            cfg = _port_cfg([*base, f"model.remat={r}"])
            model = build_model(cfg.model, cfg.grid, device=cuda_device, seed=3).train()
            model.seed_dropout(5)
            flash_attention.fwd_launches = 0
            out = model(x)
            (out * w).mean().backward()
            runs.append((out.detach(), {k: p.grad for k, p in model.named_parameters()},
                         dict(model.named_buffers()), flash_attention.fwd_launches))
    finally:
        torch.backends.cudnn.deterministic = saved
    (out0, g0, b0, n0), (out1, g1, b1, n1) = runs
    assert (n0, n1) == (1, 1 if remat == "resnet" else 2)
    torch.testing.assert_close(out1, out0, atol=1e-5, rtol=0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=1e-4, rtol=0, msg=k)
    for k in b0:
        torch.testing.assert_close(b1[k], b0[k], atol=1e-6, rtol=0, msg=k)


def _ring(chunks, w, n, plain):
    """(out, lse (2, 4, T), dq, dk, dv) over the whole T of the virtual ring."""
    from seld_tpu_torch.ops.ring_attention import virtual_ring_attention, virtual_ring_backward

    outs, lses = virtual_ring_attention(*chunks, plain=plain)
    grads = virtual_ring_backward(*chunks, list(w.chunk(n, dim=2)), outs, lses, plain=plain)
    return (torch.cat(outs, 2), torch.cat([x.view(2, 4, -1) for x in lses], 2),
            *(torch.cat(x, 2) for x in grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_virtual_ring_matches_k3_on_card(cuda_device, n, dtype):
    """K5 over n virtual ranks, one K3-family launch a lane and step forward
    (the merge in the epilogue) and two backward (the sums in the stores):
    in float32 against K3 over the whole T at the JAX ring tests' bars
    (out, lse, dq, dk, dv); in bf16 against the float32 plain ring on the
    same bf16-rounded inputs, at most 1.5x the bf16 plain ring's error, as
    K3's bf16 tests hold K3 (lse within 1e-4); at n = 1 K3's bits; n x n
    launches of each kernel, counted by K5 and by K3; no copies."""
    from seld_tpu_torch.ops.ring_attention import ring_flash_attention

    g = torch.Generator(device=cuda_device).manual_seed(n)
    q, k, v, w = (torch.randn((2, 4, 512, 64), generator=g, device=cuda_device).to(dtype)
                  for _ in range(4))
    counts = (ring_flash_attention.fwd_launches, ring_flash_attention.bwd_dq_launches,
              ring_flash_attention.bwd_dkv_launches)
    k3_counts = _k3_launches()
    copies = flash_attention.copies
    got = _ring([list(x.chunk(n, dim=2)) for x in (q, k, v)], w, n, plain=False)
    torch.cuda.synchronize()
    assert (ring_flash_attention.fwd_launches - counts[0],
            ring_flash_attention.bwd_dq_launches - counts[1],
            ring_flash_attention.bwd_dkv_launches - counts[2]) == (n * n,) * 3
    assert tuple(a - b for a, b in zip(_k3_launches(), k3_counts)) == (n * n,) * 3
    assert flash_attention.copies == copies
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = flash_attention(*leaves, return_lse=True)
    want = (out, lse.view(2, 4, -1), *torch.autograd.grad(out, leaves, w))
    if n == 1:
        for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            assert torch.equal(a, b), name
        return
    if dtype == torch.float32:
        for i, (a, b) in enumerate(zip(got, want)):
            tol = dict(rtol=2e-4, atol=2e-5) if i < 2 else dict(rtol=3e-4, atol=3e-4)
            torch.testing.assert_close(a, b, **tol)
        return
    plain = _ring([list(x.chunk(n, dim=2)) for x in (q, k, v)], w, n, plain=True)
    exact = _ring([list(x.float().chunk(n, dim=2)) for x in (q, k, v)], w.float(), n,
                  plain=True)
    torch.testing.assert_close(got[1], exact[1], rtol=0, atol=1e-4)
    for i, name in ((0, "out"), (2, "dq"), (3, "dk"), (4, "dv")):
        err = (got[i].float() - exact[i]).abs().max().item()
        plain_err = (plain[i].float() - exact[i]).abs().max().item()
        assert err <= 1.5 * plain_err + 1e-6, (name, err, plain_err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_virtual_ring_is_bit_reproducible_on_card(cuda_device, dtype):
    """No atomics in the ring modes: two runs give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(40)
    q, k, v, w = (torch.randn((2, 4, 1000, 64), generator=g, device=cuda_device).to(dtype)
                  for _ in range(4))
    chunks = [list(x.chunk(4, dim=2)) for x in (q, k, v)]
    first, second = _ring(chunks, w, 4, plain=False), _ring(chunks, w, 4, plain=False)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_virtual_ring_is_one_kernel_a_step_on_card(cuda_device):
    """A bf16 ring at n = 4 on the profiler: forward, 16 launches of the
    wgmma forward kernel and nothing else; backward, 16 dQ and 16 dK/dV
    launches, each step's dQ launches before its dK/dV ones, and no other
    kernel until the last of them (then only the dk and dv casts at home,
    2 n at most)."""
    from torch.profiler import ProfilerActivity, profile

    from seld_tpu_torch.ops.ring_attention import virtual_ring_attention, virtual_ring_backward

    q, k, v, w = _k3_case(cuda_device, 2, 8, 1000, 64, torch.bfloat16, seed=41)
    qs, ks, vs, ws = (list(x.chunk(4, dim=2)) for x in (q, k, v, w))
    outs, lses = virtual_ring_attention(qs, ks, vs)
    virtual_ring_backward(qs, ks, vs, ws, outs, lses)
    torch.cuda.synchronize()

    def kernels(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # behind a spin (left out): a session can lose the first events it sees
            torch.cuda._sleep(int(5e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3))
            result = fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not e.is_user_annotation and "spin_kernel" not in e.name),
                        key=lambda e: e.time_range.start)
        return result, [e.name for e in events]

    (outs, lses), names = kernels(lambda: virtual_ring_attention(qs, ks, vs))
    assert len(names) == 16 and all("flash_fwd_wgmma_kernel" in n for n in names), names
    _, names = kernels(lambda: virtual_ring_backward(qs, ks, vs, ws, outs, lses))
    flash = [i for i, n in enumerate(names) if "flash_" in n]
    kinds = ["dq" if "flash_dq_wgmma" in names[i] else "dkv" for i in flash]
    assert kinds == (["dq"] * 4 + ["dkv"] * 4) * 4, names
    assert flash == list(range(32)) and len(names) <= 32 + 2 * 4, names


@pytest.mark.parametrize("b,h,t,dh", [(2, 8, 1000, 64), (1, 3, 37, 80), (3, 1, 130, 16),
                                      (1, 1, 64, 128)])
def test_launchers_encode_the_tensor_maps_of_tma_geometry(cuda_device, b, h, t, dh):
    """The C launchers' tensor maps, from the strides alone, hold the values
    of tma_geometry, the plain version of that encoding (the model's layout,
    contiguous tensors, a size-1 dim with stride 0)."""
    from seld_tpu_torch.ops.flash_attention import (
        bwd_box_rows,
        fwd_block_rows,
        tensor_map_geometry,
        tma_geometry,
    )

    q, k, v, w = _k3_case(cuda_device, b, h, t, dh, torch.bfloat16, seed=42)
    out = torch.empty((b, t, h, dh), dtype=torch.bfloat16, device=cuda_device).transpose(1, 2)
    k = k.contiguous()
    v = v.contiguous()
    if b == 1:  # the batch dim with stride 0
        v = v.as_strided(v.shape, (0, *v.stride()[1:]))
    rows = bwd_box_rows(dh)
    assert tensor_map_geometry(0, q, k, v, out) == [
        *tma_geometry(q, fwd_block_rows(dh)), *tma_geometry(k, 64), *tma_geometry(v, 64),
        *tma_geometry(out, 64)]
    for which in (1, 2):
        assert tensor_map_geometry(which, q, k, v, w) == [
            n for x in (q, k, v, w) for n in tma_geometry(x, rows)]


# --- the ACCDOA families on the card ------------------------------------------


def _accdoa_vectors(lead, seed, threshold=0.5):
    """(..., 13, 3) vectors whose directions lie at least 0.5 degrees inside
    their cells (atan2 and asin round differently on the card and the CPU,
    by an ulp: no decode may hinge on one), norms from 0 to 1.5 and some one
    float32 ulp either side of the threshold."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (*lead, 13)
    az = np.radians(rng.integers(0, 36, shape) * 10.0 - 180.0 + rng.uniform(0.5, 9.5, shape))
    el = np.radians(rng.integers(0, 18, shape) * 10.0 - 90.0 + rng.uniform(0.5, 9.5, shape))
    norm = rng.uniform(0.0, 1.5, shape)
    th = np.float32(threshold)
    norm.reshape(-1)[::7] = np.nextafter(th, np.float32(2))
    norm.reshape(-1)[3::7] = np.nextafter(th, np.float32(0))
    v = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
    return torch.from_numpy((v * norm[..., None]).astype(np.float32))


def test_accdoa_scatter_decodes_match_the_cpu_on_card(cuda_device):
    """Every device decode of seld_tpu_torch.accdoa on CUDA against the same
    function on the CPU (held to the JAX package in tests/test_torch_accdoa.py):
    equal, and two runs bit-equal."""
    from seld_tpu_torch import accdoa

    single = _accdoa_vectors((16, 250), 0)
    multi = torch.stack([_accdoa_vectors((8, 250), k) for k in range(3)], dim=2)
    cases = [(accdoa.decode_accdoa_to_grid, single), (accdoa.decode_multi_accdoa_to_grid, multi)]
    for decode, v in cases:
        want = decode(v, 18, 36, 14, 0.5)
        got = decode(v.to(cuda_device), 18, 36, 14, 0.5)
        assert torch.equal(got, decode(v.to(cuda_device), 18, 36, 14, 0.5))
        assert torch.equal(got.cpu(), want) and (want != 13).any()
    act = accdoa.multi_accdoa_class_activity(multi, 18, 36, 0.5)
    got = accdoa.multi_accdoa_class_activity(multi.to(cuda_device), 18, 36, 0.5)
    assert torch.equal(got.cpu(), act)
    assert torch.equal(accdoa.decode_vote_grid(got, 14).cpu(), accdoa.decode_vote_grid(act, 14))


def test_multi_accdoa_at_long_windows_runs_k3_on_card(cuda_device):
    """A small float32 multi-ACCDOA model at T = 1000: the forward launches
    K3's forward once per block and agrees with the plain attention; an
    ADPIT train step launches forward, dQ and dK/dV once per block and K2
    never."""
    from seld_tpu_torch.accdoa import ADPITLossFn
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.optimizer import make_optimizer
    from seld_tpu_torch.train.state import create_train_state
    from seld_tpu_torch.train.steps import make_train_step

    cfg = _port_cfg(["model.model_type=multi_accdoa_conformer", "model.crnn_cnn_channels=8,16",
                     "model.conf_d_model=64", "model.conf_n_heads=2",
                     "model.compute_dtype=float32"])
    model = build_model(cfg.model, cfg.grid, device=cuda_device, seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((2, 1000, 4, 64), device=cuda_device, generator=gen)
    flash_attention.fwd_launches = 0
    with torch.no_grad():
        got = model(x)
        assert flash_attention.fwd_launches == cfg.model.conf_n_layers
        with force_flash(False):
            want = model(x)
    assert got.shape == (2, 1000, 3, 13, 3)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    targets = torch.zeros((2, 1000, 6, 4, 13), device=cuda_device)
    targets[:, :, 0, 0, 2] = 1.0
    targets[:, :, 0, 1, 2] = 1.0
    optimizer = make_optimizer(model.parameters(), 1e-3, 1e-4)
    step = make_train_step(model, ADPITLossFn(), optimizer, cfg.grid.num_classes)
    flash_attention.fwd_launches = flash_attention.bwd_dq_launches = 0
    flash_attention.bwd_dkv_launches = 0
    grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
    _, metrics = step(create_train_state(model, optimizer), x, targets, None, (0, 1))
    torch.cuda.synchronize()
    n = cfg.model.conf_n_layers
    assert (flash_attention.fwd_launches, flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches) == (n, n, n)
    assert (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches) == (0, 0)
    assert torch.isfinite(metrics["loss"]) and list(metrics) == ["loss", "adpit"]


def test_evaluate_model_visualizes_at_long_windows_on_card(cuda_device, tmp_path,
                                                           monkeypatch):
    """evaluate_model at T = 1000 with two visualizations: K3's forward once
    per block for every eval batch and once per block for the one forward
    of the visualization pass, whose two chosen frames reach the renderer
    as finite class-major grids with their ground truth. The renderer is a
    recording stand-in, so the card's machine needs no matplotlib."""
    import sys
    import types

    import numpy as np

    from seld_tpu_torch.data.synthetic import synthetic_corpus
    from seld_tpu_torch.eval import evaluate_model
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.targets.rasterize import bitmask_to_dense
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    drawn = []
    renderer = types.ModuleType("seld_tpu_torch.viz")
    renderer.visualize_grid_predictions = lambda gt, pred, **kw: drawn.append((gt, pred, kw))
    monkeypatch.setitem(sys.modules, "seld_tpu_torch.viz", renderer)
    cfg = _port_cfg(["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                     "model.conf_d_model=64", "model.conf_n_heads=2",
                     "model.compute_dtype=float32", "window.window_seconds=20.0",
                     "train.batch_size=4", f"data.base_path={tmp_path}"])
    model = build_model(cfg.model, cfg.grid, device=cuda_device, seed=0)
    save_checkpoint(tmp_path / "checkpoints" / "best" / "epoch_0001.pt", model, cfg, epoch=1,
                    meta={"epoch": 1, "train_loss": 0.0, "test_loss": 0.0})
    corpus = synthetic_corpus(cfg, n_files=1, seconds=30.0, seed=1, train=False,
                              device=cuda_device)
    assert corpus.window_frames == 1000
    flash_attention.fwd_launches = 0
    report = evaluate_model(cfg, corpus, tmp_path / "checkpoints", num_visualizations=2,
                            device=cuda_device)
    torch.cuda.synchronize()
    eval_steps = -(-len(corpus) // cfg.train.batch_size)
    assert flash_attention.fwd_launches == (eval_steps + 1) * cfg.model.conf_n_layers
    assert len(report["visualizations"]) == len(drawn) == 2
    m, g = cfg.grid.num_classes, cfg.grid.n_cells
    for record, (gt, pred, kw) in zip(report["visualizations"], drawn):
        assert str(kw["save_path"]) == record["save_path"]
        assert record["save_path"].startswith(str(tmp_path / "outputs" / "test_visualizations"))
        assert pred.shape == gt.shape == (m, g) and np.isfinite(pred).all()
        mask = corpus.gather([record["window_idx"]])[1][0, record["time_idx"]]
        assert mask.any()
        np.testing.assert_array_equal(gt, bitmask_to_dense(mask, m).T)


def _tiny_predictor(cuda_device, tmp_path, feature_set, batch_windows=3):
    """A seeded float32 tiny Conformer on `feature_set`, saved and served."""
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    cfg = _port_cfg(["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                     "model.conf_d_model=32", "model.conf_n_heads=2", "model.conf_n_layers=1",
                     "model.compute_dtype=float32", "window.window_seconds=0.4",
                     f"features.feature_set={feature_set}"])
    model = build_model(cfg.model, cfg.grid, device=cuda_device, seed=0,
                        in_channels=feature_channels(feature_set))
    save_checkpoint(tmp_path / f"{feature_set}.pt", model, cfg)
    return SELDPredictor(tmp_path / f"{feature_set}.pt", batch_windows=batch_windows,
                         device=cuda_device)


@pytest.mark.parametrize("feature_set", ["mel", "mel_iv"])
@pytest.mark.parametrize("overlap", [0.0, 0.5])
def test_stream_equals_offline_on_card(cuda_device, tmp_path, feature_set, overlap):
    """Streaming on the card: each frame block one K1 ("mel") or K4
    ("mel_iv") launch on the uploaded segment's strided view, the classes
    bit-equal to the offline predict for several chunkings and tiny clips."""
    import numpy as np

    from seld_tpu_torch.stream import StreamingSession

    pred = _tiny_predictor(cuda_device, tmp_path, feature_set)
    kernel = log_mel_frames if feature_set == "mel" else spatial_features
    wave = (0.2 * np.random.default_rng(1).standard_normal((4, 77_777))).astype(np.float32)
    for n in (100, 479, 481, 700, wave.shape[1]):
        clip = wave[:, :n]
        want = pred.predict_waveform(clip, overlap=overlap).classes
        for size in (480, 8_888, 24_000, n):
            s = StreamingSession(pred, overlap=overlap)
            kernel.launches = 0
            parts = [c for i in range(0, n, size) for _, c in s.push(clip[:, i:i + size])]
            parts += [c for _, c in s.flush()]
            torch.cuda.synchronize()
            assert kernel.launches == s.frame_blocks >= 1
            np.testing.assert_array_equal(np.concatenate(parts), want, err_msg=f"{n} {size}")


def test_tta16_launch_counts_on_card(cuda_device, tmp_path):
    """TTA16 on "mel_iv": K4 once per predict (the views permute the
    features), 16 model forwards per batch of windows (8 at fold 2), and
    identity TTA bit-equal to the plain predict."""
    import numpy as np

    pred = _tiny_predictor(cuda_device, tmp_path, "mel_iv", batch_windows=2)
    wave = (0.2 * np.random.default_rng(2).standard_normal((4, 3 * 24_000))).astype(np.float32)
    plain = pred.predict_waveform(wave).classes
    calls = []
    pred.model.register_forward_hook(lambda m, i, o: calls.append(i[0].shape[0]))
    n_windows = -(-(1 + wave.shape[1] // 480) // pred.win)
    batches = -(-n_windows // 2)
    for transforms, fold, forwards in (((0,), 1, batches), (None, 1, 16 * batches),
                                       (None, 2, 8 * batches)):
        pred.tta(transforms, fold=fold)
        calls.clear()
        spatial_features.launches = 0
        got = pred.predict_waveform(wave).classes
        torch.cuda.synchronize()
        assert spatial_features.launches == 1
        assert len(calls) == forwards and set(calls) == {2 * fold}
        if transforms == (0,):
            np.testing.assert_array_equal(got, plain)


def test_k3_operator_launches_the_kernel_on_card(cuda_device):
    """K3's forward as the operator an exported program calls: the kernel's
    bits (out and lse) and one counted launch a call."""
    from seld_tpu_torch.ops.flash_attention import _kernel_ready

    g = torch.Generator(device=cuda_device).manual_seed(17)
    q, k, v = (torch.randn((2, 4, 600, 64), generator=g, device=cuda_device)
               .to(torch.bfloat16) for _ in range(3))
    want = launch_forward(_kernel_ready(q), _kernel_ready(k), _kernel_ready(v), 0.125)
    before = flash_attention.fwd_launches
    got = torch.ops.seld_tpu_torch.flash_attention_fwd(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert flash_attention.fwd_launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_artifact_runs_k3_inside_the_program_on_card(cuda_device, tmp_path):
    """A tiny Conformer at 600-frame windows exported on the card: K3's
    operator once in each program's graph, one forward launch a batch from
    the loaded program, the artifact's predict bit-equal to the
    checkpoint's at overlap 0 and 0.5."""
    import numpy as np

    from seld_tpu_torch.export import export_serving
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    cfg = _port_cfg(["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                     "model.conf_d_model=32", "model.conf_n_heads=2", "model.conf_n_layers=1",
                     "model.compute_dtype=bfloat16", "window.window_seconds=12.0"])
    model = build_model(cfg.model, cfg.grid, device=cuda_device, seed=0,
                        in_channels=feature_channels(cfg.features.feature_set))
    save_checkpoint(tmp_path / "long.pt", model, cfg)
    out = export_serving(tmp_path / "long.pt", tmp_path / "long.pt2", batch_windows=2,
                         device=cuda_device)
    for path in (out, tmp_path / "long.pt2.probs"):
        with open(path, "rb") as f:
            nodes = torch.export.load(f).graph.nodes
        assert sum("flash_attention_fwd" in str(n.target) for n in nodes) == 1
    live = SELDPredictor(tmp_path / "long.pt", batch_windows=2, device=cuda_device)
    art = SELDPredictor.from_artifact(out, device=cuda_device)
    wave = (0.2 * np.random.default_rng(5).standard_normal((4, 30 * 24_000))).astype(np.float32)
    for overlap in (0.0, 0.5):
        np.testing.assert_array_equal(art.predict_waveform(wave, overlap=overlap).classes,
                                      live.predict_waveform(wave, overlap=overlap).classes)
    flash_attention.fwd_launches = 0
    art.predict_waveform(wave)
    torch.cuda.synchronize()
    assert flash_attention.fwd_launches == 2  # 3 windows of 600 frames: 2 batches of 2


def test_batched_daemon_streams_equal_offline_on_card(cuda_device, tmp_path):
    """Three concurrent streams through the daemon with cross-stream
    batching, chunked differently: each bit-equal to the offline predict
    (every window in its offline batch slot), K1 launches = the streams'
    frame blocks."""
    import threading

    import numpy as np

    from seld_tpu_torch.serve import SELDServer, stream_client

    pred = _tiny_predictor(cuda_device, tmp_path, "mel", batch_windows=4)
    wave = (0.2 * np.random.default_rng(3).standard_normal((4, 6 * 24_000))).astype(np.float32)
    want = pred.predict_waveform(wave).classes
    server = SELDServer(pred, port=0, batch_streams=True)
    serving = server.serve_background()
    results = {}
    sizes = (24_000, 17_000, 9_000)
    threads = [threading.Thread(target=lambda n=n: results.setdefault(n, stream_client(
        "127.0.0.1", server.port, [wave[:, i:i + n] for i in range(0, wave.shape[1], n)],
        timeout=60)[0])) for n in sizes]
    log_mel_frames.launches = 0
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        torch.cuda.synchronize()
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    assert sorted(results) == sorted(sizes)
    for n, classes in results.items():
        np.testing.assert_array_equal(classes, want, err_msg=str(n))
    assert log_mel_frames.launches == sum(-(-wave.shape[1] // n) + 1 for n in sizes)
    assert server.batcher.rows_run > 0


@pytest.mark.parametrize("m,k,n", [(3, 36, 39), (16, 63, 14), (17, 90, 117), (64_000, 40, 64),
                                   (2_000, 512, 2048), (2_000, 1024, 9072)])
def test_int8_matmul_is_exact_on_card(cuda_device, m, k, n):
    """cuBLASLt's int8 GEMM through int8_matmul, padded to its shape rules
    where a shape breaks them, bit-equal to the float64 product."""
    from seld_tpu_torch.quant import int8_matmul, int8_matmul_reference

    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda_device, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=cuda_device, dtype=torch.int8)
    before = int8_matmul.launches
    got = int8_matmul(a, w)
    assert int8_matmul.launches == before + 1 and got.dtype == torch.int32
    assert torch.equal(got, int8_matmul_reference(a, w))


@pytest.mark.parametrize("feature_set", ["mel", "mel_iv"])
def test_int8_predict_stream_and_tta_on_card(cuda_device, tmp_path, feature_set):
    """The int8 predictor on the card: one int8 GEMM a quantized layer a
    forward, the stream bit-equal to offline, and int8 under TTA equal
    whichever of tta() and quantize() came first."""
    import numpy as np

    from seld_tpu_torch.quant import eligible_names, int8_matmul
    from seld_tpu_torch.stream import stream_predict

    pred = _tiny_predictor(cuda_device, tmp_path, feature_set, batch_windows=2)
    wave = (0.2 * np.random.default_rng(3).standard_normal((4, 3 * 24_000))).astype(np.float32)
    pred.quantize(calib_waves=[wave])
    n_windows = -(-(1 + wave.shape[1] // 480) // pred.win)
    int8_matmul.launches = 0
    offline = pred.predict_waveform(wave).classes
    torch.cuda.synchronize()
    assert int8_matmul.launches == len(eligible_names(pred.cfg.model)) * -(-n_windows // 2)
    chunks = [wave[:, i:i + 8_888] for i in range(0, wave.shape[1], 8_888)]
    np.testing.assert_array_equal(stream_predict(pred, chunks).classes, offline)
    if feature_set == "mel_iv":
        first = pred.tta((0, 5)).predict_waveform(wave).classes
        other = _tiny_predictor(cuda_device, tmp_path, feature_set, batch_windows=2).tta((0, 5))
        other.quantize(calib_waves=[wave])
        np.testing.assert_array_equal(other.predict_waveform(wave).classes, first)


DISTILL_TEACHER = ["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                   "model.conf_d_model=64", "model.conf_n_heads=2", "model.conf_n_layers=1"]
DISTILL_STUDENT = [*DISTILL_TEACHER[:-1], "model.conf_n_layers=2"]


def _distilling_step(cuda_device, qat=False, t=512):
    """A bf16 distilling train step of a 2-block Conformer student under a
    1-block Conformer teacher (seeded weights) at T frames, with a seeded
    batch: (step, state, spec, mel, mask)."""
    from functools import partial

    from seld_tpu_torch.distill import DistillSpec, grid_kd_loss
    from seld_tpu_torch.losses.seld_loss import make_class_weights
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.optimizer import make_optimizer
    from seld_tpu_torch.train.state import create_train_state
    from seld_tpu_torch.train.steps import make_train_step

    tcfg, cfg = _port_cfg(DISTILL_TEACHER), _port_cfg(DISTILL_STUDENT)
    teacher = build_model(tcfg.model, tcfg.grid, device=cuda_device, seed=1)
    spec = DistillSpec(teacher=teacher.requires_grad_(False).eval(), alpha=0.5,
                       temperature=2.0, kd=partial(grid_kd_loss, class_weights=make_class_weights(
                           14).to(cuda_device)))
    model = build_model(cfg.model, cfg.grid, device=cuda_device, seed=0)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    mel = torch.randn((4, t, 4, 64), device=cuda_device, generator=gen)
    mask = torch.randint(0, 2 ** 13, (4, t, cfg.grid.n_cells), device=cuda_device,
                         generator=gen).to(torch.int16)
    optimizer = make_optimizer(model.parameters(), 1e-3, 1e-4)
    step = make_train_step(model, SELDLossFn(cfg.loss, cfg.grid), optimizer,
                           cfg.grid.num_classes, qat=qat, distill=spec)
    return step, create_train_state(model, optimizer), spec, mel, mask


def test_distilling_step_launch_counts_on_card(cuda_device):
    """At T = 512 the teacher's forward runs K3's forward once a block and
    the student's forward and backward once a block each: forward 1 + 2,
    dQ and dK/dV 2; K2 forward and backward once (the hard loss); the KD
    terms finite."""
    step, state, _, mel, mask = _distilling_step(cuda_device)
    flash_attention.fwd_launches = flash_attention.bwd_dq_launches = 0
    flash_attention.bwd_dkv_launches = 0
    grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
    log_mel_frames.launches = 0
    _, metrics = step(state, mel, mask, None, (0, 1))
    torch.cuda.synchronize()
    assert (flash_attention.fwd_launches, flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches) == (3, 2, 2)
    assert (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches) == (1, 1)
    assert log_mel_frames.launches == 0
    assert set(metrics) == {"loss", "class_mse", "hard", "kd"}
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("qat", [False, True], ids=["plain", "qat"])
def test_distilling_step_teacher_equals_its_eval_forward_on_card(cuda_device, qat):
    """The teacher's output inside the step is its eval forward on the same
    batch bit for bit, with and without QAT on the student (the teacher
    runs outside quant.qat())."""
    step, state, spec, mel, mask = _distilling_step(cuda_device, qat=qat)
    seen = []
    hook = spec.teacher.register_forward_hook(lambda m, i, out: seen.append(out))
    try:
        step(state, mel, mask, None, (0, 1))
    finally:
        hook.remove()
    with torch.no_grad():
        want = spec.teacher(mel)
    assert len(seen) == 1 and torch.equal(seen[0], want)


def test_profiled_long_window_steps_count_k2_and_k3_as_the_counters_on_card(cuda_device,
                                                                            tmp_path):
    """train.profile_steps=2 on the full-width flagship at T = 1000 (train
    steps of 2 windows, the corpus's windows padded past its end): the
    port's profile_summary counts K2's and K3's kernels in the trace by
    name exactly as the launch counters count two train steps (K2 forward
    and backward once a step, K3's forward, dQ and dK/dV once a conformer
    block)."""
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.data.synthetic import synthetic_corpus
    from seld_tpu_torch.tools import profile_summary
    from seld_tpu_torch.train.trainer import train_model

    cfg = parse_overrides(Config(), [
        f"data.base_path={tmp_path}", "window.window_seconds=20.0", "window.hop_seconds=1.0",
        "train.batch_size=2", "train.num_epochs=1", "train.profile_steps=2"])
    train_c = synthetic_corpus(cfg, n_files=1, seconds=6.0, seed=0, device=cuda_device)
    test_c = synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=1, train=False,
                              device=cuda_device)
    train_steps, eval_steps = -(-len(train_c) // 2), -(-len(test_c) // 2)
    assert train_steps >= 3  # steps 1 and 2 traced
    fa = flash_attention
    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
    train_model(cfg, train_c, test_c, device=cuda_device)
    blocks = cfg.model.resnet_conf_n_layers
    # the counters over the whole run: once a train or eval step, K3 a block
    steps = train_steps + eval_steps
    assert (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches) == (steps, train_steps)
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (
        steps * blocks, train_steps * blocks, train_steps * blocks)
    by_name = profile_summary.event_counts(tmp_path / "outputs" / "profile")
    traced = {pattern: sum(n for name, n in by_name.items() if pattern in name)
              for pattern in ("grid_loss_fwd", "grid_loss_bwd", "flash_fwd_wgmma",
                              "flash_dq_wgmma", "flash_dkv_wgmma")}
    assert traced == {"grid_loss_fwd": 2, "grid_loss_bwd": 2, "flash_fwd_wgmma": 2 * blocks,
                      "flash_dq_wgmma": 2 * blocks, "flash_dkv_wgmma": 2 * blocks}
    rows, plane = profile_summary.summarize(tmp_path / "outputs" / "profile", top=5)
    assert plane == "/device:cuda:0" and len(rows) == 5


# --- bf16 parameters (model.param_dtype=bfloat16) ----------------------------------------

BF16_FLAGSHIP = ["model.resnet_conf_d_model=64", "model.resnet_conf_n_heads=2",
                 "model.resnet_conf_n_layers=1", "model.param_dtype=bfloat16"]


def _bf16_ulps(a, b):
    def ordered(t):
        i = t.view(torch.int16).int() & 0xFFFF
        return torch.where(i >= 0x8000, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def test_bf16_parameter_flagship_step_through_k3_on_card(cuda_device):
    """A train step of the small bf16-parameter flagship at T = 512: K2
    forward and backward once, K3's forward, dQ and dK/dV once for its one
    conformer block; bf16 gradients, ChainAdam's bf16 moments, the weights
    still bf16 after the step, and that step within 1 bf16 ulp of the same
    ChainAdam step on the CPU from the card's gradients."""
    import copy

    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.optimizer import ChainAdam, make_optimizer
    from seld_tpu_torch.train.state import create_train_state
    from seld_tpu_torch.train.steps import make_train_step

    cfg = _port_cfg(BF16_FLAGSHIP)
    model = build_model(cfg.model, cfg.grid, device=cuda_device, seed=0)
    before = copy.deepcopy(model).cpu()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mel = torch.randn((2, FLASH_MIN_SEQ_LEN, 4, 64), device=cuda_device, generator=gen)
    mask = torch.randint(0, 2 ** 13, (2, FLASH_MIN_SEQ_LEN, cfg.grid.n_cells),
                         device=cuda_device, generator=gen).to(torch.int16)
    optimizer = make_optimizer(model.parameters(), 1e-3, 1e-4)
    assert isinstance(optimizer, ChainAdam)
    step = make_train_step(model, SELDLossFn(cfg.loss, cfg.grid), optimizer, cfg.grid.num_classes)
    fa = flash_attention
    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
    metrics = step(create_train_state(model, optimizer), mel, mask, None, (0, 1))[1]
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == (1, 1, 1)
    assert (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches) == (1, 1)
    params = dict(model.named_parameters())
    assert {p.dtype for p in params.values()} == {torch.bfloat16}
    assert {p.grad.dtype for p in params.values()} == {torch.bfloat16}
    assert {s["mu"].dtype for s in optimizer.state.values()} == {torch.bfloat16}
    cpu_params = dict(before.named_parameters())
    for name, p in cpu_params.items():
        p.grad = params[name].grad.cpu()
    make_optimizer(cpu_params.values(), 1e-3, 1e-4).step()
    for name, p in cpu_params.items():
        assert int(_bf16_ulps(params[name].detach().cpu(), p.detach()).max()) <= 1, name


def test_bf16_parameter_predict_on_card(cuda_device, tmp_path):
    """A saved bf16-parameter checkpoint serves on the card: K1 once a
    predict; with float32 compute the bf16 weights upcast exactly, so its
    logits equal the CPU's within the float32 card-vs-CPU bar (1e-3)."""
    import numpy as np

    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    cfg = _port_cfg([*BF16_FLAGSHIP, "model.compute_dtype=float32"])
    model = build_model(cfg.model, cfg.grid, device=cuda_device, seed=0)
    save_checkpoint(tmp_path / "m.pt", model, cfg)
    assert load_checkpoint(tmp_path / "m.pt")[1]["proj.weight"].dtype == torch.bfloat16
    pred = SELDPredictor(tmp_path / "m.pt", device=cuda_device)
    assert {p.dtype for p in pred.model.parameters()} == {torch.bfloat16}
    wave = (0.1 * np.random.default_rng(0).standard_normal((4, 5 * 24_000))).astype(np.float32)
    log_mel_frames.launches = 0
    classes = pred.predict_waveform(wave).classes
    assert log_mel_frames.launches == 1
    assert classes.shape == (251, cfg.grid.n_cells) and 0 <= classes.min()
    x = torch.randn((2, 50, 4, 64), generator=torch.Generator().manual_seed(1))
    cpu = build_model(cfg.model, cfg.grid, device="cpu", seed=None)
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, want = model(x.to(cuda_device)).cpu(), cpu(x)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("norm_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_norms_with_bf16_parameters_equal_float32_ones_on_card(cuda_device, norm_dtype, train):
    """BatchNorm casts bf16 parameters to float32 and LayerNorm to the
    input's dtype, so on CUDA both give what the same weights in float32
    give, bit for bit, for a float32 and a bf16 input."""
    from seld_tpu_torch.models.layers import BatchNorm, LayerNorm

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    w = (torch.rand(16, device=cuda_device, generator=gen) + 0.5).bfloat16()
    b = torch.randn(16, device=cuda_device, generator=gen).bfloat16()
    pairs = []
    for make, n in ((lambda: BatchNorm(16, norm_dtype), 16), (lambda: LayerNorm(8, norm_dtype), 8)):
        m16, m32 = make().to(cuda_device).train(train), make().to(cuda_device).train(train)
        m16.weight, m16.bias = torch.nn.Parameter(w[:n].clone()), torch.nn.Parameter(b[:n].clone())
        m32.weight, m32.bias = torch.nn.Parameter(w[:n].float()), torch.nn.Parameter(b[:n].float())
        pairs.append((m16, m32))
    x = torch.randn((4, 16, 50, 8), device=cuda_device, generator=gen)
    with torch.no_grad():
        for xin in (x, x.bfloat16()):
            for m16, m32 in pairs:
                assert torch.equal(m16(xin), m32(xin))
    assert torch.equal(pairs[0][0].running_var, pairs[0][1].running_var)
