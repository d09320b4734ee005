"""The port's attention against seld_tpu's, on the CPU: the plain version
of kernel K3 against the Pallas flash-attention kernels in interpret mode
(forward, logsumexp and the three gradients), the dispatch and its
`force_flash` override, and a conformer attention layer and the small
flagship at T = 512 against the JAX package running its flash kernels.
Inputs are seeded numpy arrays handed to both packages; weights cross
through seld_tpu_torch.convert.state_dict_from_jax."""

import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import GridConfig, ModelConfig
from seld_tpu.models import build_model, init_variables
from seld_tpu.models.layers import MultiHeadSelfAttention
from seld_tpu.ops import attention as jax_attention
from seld_tpu.ops import flash_attention as jax_flash
from seld_tpu_torch.config import ModelConfig as PortModelConfig
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.models import layers as port_layers
from seld_tpu_torch.ops import attention as port_attention
from seld_tpu_torch.ops import flash_attention as port_flash
from tests.test_torch_model import ATOL, RTOL, one_torch_thread, randomize  # noqa: F401

B, H, DH = 1, 2, 32
LENGTHS = (130, 250, 640)  # ragged in one TPU block, the default window, two blocks
# the JAX kernel tests' own bars (tests/test_pallas_kernels.py): float32
# sums in another order
FWD_ATOL, LSE_ATOL = 2e-5, 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _qkvw(t, seed, key_scale=1.0, dh=DH):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, H, t, dh)).astype(np.float32) for _ in range(4))
    return q, key_scale * k, v, w


@functools.cache
def _jax_side(t, key_scale=1.0):
    """The Pallas kernels in interpret mode on the case of length t:
    (out, lse, {bwd_impl: (dq, dk, dv)})."""
    q, k, v, w = map(jnp.asarray, _qkvw(t, seed=t, key_scale=key_scale))
    scale = DH ** -0.5
    out, lse = jax_flash._flash_attention_fwd_impl(scale, True, q, k, v)
    grads = {}
    for impl in ("pallas", "xla"):
        fn = lambda q, k, v: (jax_flash.flash_attention(  # noqa: E731
            q, k, v, interpret=True, bwd_impl=impl) * w).sum()
        grads[impl] = [np.asarray(g) for g in jax.grad(fn, argnums=(0, 1, 2))(q, k, v)]
    return np.asarray(out), np.asarray(lse)[:, :t, 0], grads


@functools.cache
def _port_side(t, key_scale=1.0):
    q, k, v, w = (torch.from_numpy(x) for x in _qkvw(t, seed=t, key_scale=key_scale))
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    out, lse = port_flash.flash_attention_reference(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), w)
    return out.detach().numpy(), lse.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("t", LENGTHS)
def test_reference_forward_matches_pallas_kernel(t):
    want, got = _jax_side(t)[0], _port_side(t)[0]
    assert got.shape == want.shape == (B, H, t, DH)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("t", LENGTHS)
def test_reference_lse_matches_pallas_kernel(t):
    want, got = _jax_side(t)[1], _port_side(t)[1]
    assert got.shape == want.shape == (B * H, t)
    np.testing.assert_allclose(got, want, rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("t", LENGTHS)
def test_reference_gradients_match_jax(t, impl):
    for name, got, want in zip(("dq", "dk", "dv"), _port_side(t)[2], _jax_side(t)[2][impl]):
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)


def test_reference_gives_no_weight_to_padded_keys():
    """T = 130 pads to 256 on the TPU side; keys ten times larger sharpen
    the softmax so that a leaked padded key would show. 5e-5 as in
    tests/test_pallas_kernels.py."""
    want, got = _jax_side(130, 10.0)[0], _port_side(130, 10.0)[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_wrapper_takes_reference_for_cpu_tensors_and_counts_nothing(monkeypatch):
    calls = []
    plain = port_flash.flash_attention_reference
    monkeypatch.setattr(port_flash, "flash_attention_reference",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    fa = port_flash.flash_attention
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches, fa.copies)
    q, k, v, _ = (torch.from_numpy(x) for x in _qkvw(70, seed=1))
    out, lse = fa(q, k, v, return_lse=True)
    assert calls == [(B, H, 70, DH)] and out.shape == q.shape and lse.shape == (B * H, 70)
    assert torch.equal(fa(q, k, v), out)
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches, fa.copies) == before


@pytest.mark.parametrize("make,err", [
    (lambda q, k, v: (q.half(), k.half(), v.half()), TypeError),
    (lambda q, k, v: (q.double(), k.double(), v.double()), TypeError),
    (lambda q, k, v: (q, k.bfloat16(), v), TypeError),
    (lambda q, k, v: (q[..., :24], k[..., :24], v[..., :24]), ValueError),  # Dh = 24
    (lambda q, k, v: (q.repeat(1, 1, 1, 5)[..., :144],) * 3, ValueError),  # Dh = 144
    (lambda q, k, v: (q, k[:, :, :-1], v), ValueError),
    (lambda q, k, v: (q[0], k[0], v[0]), ValueError),
])
def test_wrapper_rejects_what_the_kernel_cannot_take(make, err):
    q, k, v, _ = (torch.from_numpy(x) for x in _qkvw(64, seed=2))
    with pytest.raises(err, match="K3"):
        port_flash.flash_attention(*make(q, k, v))


def test_reference_rounds_like_the_kernel_in_bfloat16():
    """bf16 inputs: float32 scores and softmax, probabilities rounded to
    bf16 before the value product, float32 accumulation, bf16 out; the
    cotangent of the scores rounded to bf16 on the way back."""
    q, k, v, w = (torch.from_numpy(x).bfloat16() for x in _qkvw(96, seed=3))
    out, lse = port_flash.flash_attention_reference(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    s = (q.float() @ k.float().transpose(-1, -2)) * DH ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    assert torch.equal(out, want.bfloat16())
    exact, _ = port_flash.flash_attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - exact).abs().max() < 2e-2  # bf16 has 8 bits
    leaf = q.clone().requires_grad_(True)
    seen = []
    s = port_flash._RoundCotangent.apply(leaf.float() * 3.0, torch.bfloat16)
    s.register_hook(lambda g: seen.append(g))
    (s * torch.full_like(s, 1.2345678)).sum().backward()
    # 1.2345678 rounds to bf16's 1.234375 before it reaches the product by 3
    assert torch.equal(leaf.grad.float(), torch.full_like(s, 3.0 * 1.234375).bfloat16().float())


def test_multi_head_attention_matches_jax_einsum_at_a_long_window():
    q, k, v, _ = _qkvw(640, seed=4)
    want = np.asarray(jax_attention.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_flash=False))
    got = port_attention.multi_head_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_ATOL)


def test_force_flash_true_raises_for_cpu_tensors_and_false_is_the_plain_product(monkeypatch):
    q, k, v, _ = (torch.from_numpy(x) for x in _qkvw(600, seed=5))
    auto = port_attention.multi_head_attention(q, k, v)  # CPU: plain at any T
    monkeypatch.setattr(port_attention, "flash_attention", None)  # must not be reached
    with port_attention.force_flash(False):
        assert torch.equal(port_attention.multi_head_attention(q, k, v), auto)
    with port_attention.force_flash(True):
        with pytest.raises(ValueError, match="K3 and needs CUDA"):
            port_attention.multi_head_attention(q, k, v)
    assert port_attention._FORCE.get() is None  # restored on exit, and after a raise
    with pytest.raises(RuntimeError, match="boom"):
        with port_attention.force_flash(True):
            raise RuntimeError("boom")
    assert port_attention._FORCE.get() is None


def test_dispatch_sends_long_cuda_tensors_to_k3(monkeypatch):
    """The length rule itself, on stand-ins that claim to be CUDA tensors:
    K3 from FLASH_MIN_SEQ_LEN on, the plain product below it, and
    force_flash overriding both ways."""

    class OnCard(torch.Tensor):
        is_cuda = True

    sent = []
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda q, k, v, scale=None: sent.append(q.shape[-2]) or q)
    n = port_attention.FLASH_MIN_SEQ_LEN
    assert n == jax_attention.FLASH_MIN_SEQ_LEN == 512
    for t in (n - 1, n, n + 1):
        x = torch.zeros((1, 1, t, 16)).as_subclass(OnCard)
        port_attention.multi_head_attention(x, x, x)
    assert sent == [n, n + 1]
    x = torch.zeros((1, 1, 8, 16)).as_subclass(OnCard)
    with port_attention.force_flash(True):
        port_attention.multi_head_attention(x, x, x)
    big = torch.zeros((1, 1, n, 16)).as_subclass(OnCard)
    with port_attention.force_flash(False):
        port_attention.multi_head_attention(big, big, big)
    assert sent == [n, n + 1, 8]


# --- model code at T = 512, the JAX side through its flash kernels --------

SMALL = dict(resnet_conf_d_model=32, resnet_conf_n_heads=2, resnet_conf_n_layers=1,
             compute_dtype="float32")
T_LONG = 512


@pytest.fixture(scope="module")
def long_flagship():
    cfg = ModelConfig(**SMALL)
    model = build_model(cfg, GridConfig())
    variables = randomize(init_variables(
        model, jax.random.PRNGKey(0), jnp.zeros((1, 8, 4, 64), jnp.float32)))
    port = build_port_model(PortModelConfig(**SMALL), device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables, PortModelConfig(**SMALL)))
    return model, variables, port


def test_attention_layer_matches_jax_flash_path_at_512(long_flagship):
    _, variables, port = long_flagship
    layer = MultiHeadSelfAttention(d_model=32, n_heads=2)
    sub = {"params": variables["params"]["block_0"]["MultiHeadSelfAttention_0"]}
    x = np.random.default_rng(6).standard_normal((1, T_LONG, 32)).astype(np.float32)
    with jax_attention.force_flash(True, interpret=True):
        want = np.asarray(layer.apply(sub, x, train=False))
    port_layer = port_layers.MultiHeadSelfAttention(32, 2)
    port_layer.load_state_dict({k[len("blocks.0.attn."):]: v
                                for k, v in port.state_dict().items()
                                if k.startswith("blocks.0.attn.")})
    with torch.no_grad():
        got = port_layer.eval()(torch.from_numpy(x)).numpy()
    # one layer: float32 sums in another order
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_flagship_matches_jax_flash_path_at_512(long_flagship):
    model, variables, port = long_flagship
    x = np.random.default_rng(7).standard_normal((1, T_LONG, 4, 64)).astype(np.float32)
    with jax_attention.force_flash(True, interpret=True):
        want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, T_LONG, 14, 648)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# --- the bf16 kernels' tile loops, emulated in numpy -----------------------
#
# csrc/flash_attention_kernel.cu's wgmma kernels: a block owns 128 rows,
# streams tiles whose last one is ragged and reads Dh zero-padded to
# 64-column TMA boxes. The forward streams K/V tiles of 64 keys, masks
# keys at or beyond T to -1e30, keeps a running max m,
# forms p = exp2(s * scale * log2(e) - m * scale * log2(e)), rounds p to
# bf16 before P V and divides by the float32 sum at the end. The dQ and
# dK/dV kernels stream 64-row tiles (32 above Dh = 64), form delta in
# float32 from dO and out, p = exp2(s * scale * log2(e) - lse * log2(e)),
# feed p to dv as a bf16 pair (rounded and remainder) and ds rounded to
# bf16. `rnd` is the rounding to the kernels' type: bf16, or none to hold
# the same loops to the Pallas kernels in float32.

LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)
EMULATED = [(t, dh) for t in (37, 130, 640) for dh in (32, 48, 64)]
# the forward also at two 64-column boxes (Dh 80 and 128)
FWD_EMULATED = EMULATED + [(t, dh) for t in (37, 130, 640) for dh in (80, 128)]


def _bf16(x):
    """Round float32 to the nearest bfloat16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _no_round(x):
    return np.asarray(x, np.float32)


def _tiles(x, rows, dp):
    """(BH, T, Dh) -> (BH, T rounded up to `rows`, dp): TMA's zero fill."""
    bh, t, dh = x.shape
    out = np.zeros((bh, -(-t // rows) * rows, dp), np.float32)
    out[:, :t, :dh] = x
    return out


def _columns(dh):
    """Columns staged: one 64-column TMA box, or two."""
    return 64 if dh <= 64 else 128


def _shape(dh):
    return _columns(dh), port_flash.bwd_box_rows(dh)


def emulate_fwd(q, k, v, scale, rnd=_no_round):
    """out and lse of the forward kernel's loop; q, k, v (BH, T, Dh)."""
    bh, t, dh = q.shape
    dp, bn = _columns(dh), port_flash.FWD_BOX_KEYS
    qp = _tiles(q, port_flash.fwd_block_rows(dh), dp)
    kp, vp = _tiles(k, bn, dp), _tiles(v, bn, dp)
    c = np.float32(scale) * LOG2E
    m = np.full(qp.shape[:2], NEG, np.float32)
    l = np.zeros(qp.shape[:2], np.float32)
    o = np.zeros_like(qp)
    for n0 in range(0, kp.shape[1], bn):
        s = qp @ kp[:, n0:n0 + bn].transpose(0, 2, 1)
        s[..., n0 + np.arange(bn) >= t] = NEG
        m_new = np.maximum(m, s.max(-1))
        alpha = np.exp2((m - m_new) * c)
        p = np.exp2(s * c - (m_new * c)[..., None])
        l = l * alpha + p.sum(-1, dtype=np.float32)
        o = o * alpha[..., None] + rnd(p) @ vp[:, n0:n0 + bn]
        m = m_new
    denom = np.maximum(l, np.float32(1e-30))
    out = rnd(o / denom[..., None])
    lse = m * np.float32(scale) + np.log(denom)
    return out[:, :t, :dh], lse[:, :t]


def emulate_dq(q, k, v, g, out, lse, scale, delta=None, rnd=_no_round):
    """dq and delta of the dQ kernel's loop; arrays (BH, T, Dh), lse and
    delta (BH, T)."""
    bh, t, dh = q.shape
    dp, bn = _shape(dh)
    if delta is None:  # two threads a row in the kernel; float32 sums here too
        delta = (g.astype(np.float32) * out.astype(np.float32)).sum(-1, dtype=np.float32)
    qp, gp = _tiles(q, 128, dp), _tiles(g, 128, dp)
    kp, vp = _tiles(k, bn, dp), _tiles(v, bn, dp)
    rows = qp.shape[1]
    nlse = np.zeros((bh, rows), np.float32)
    nlse[:, :t] = -lse * LOG2E
    dl = np.zeros((bh, rows), np.float32)
    dl[:, :t] = delta
    c = np.float32(scale) * LOG2E
    dq = np.zeros_like(qp)
    for n0 in range(0, kp.shape[1], bn):
        kt, vt = kp[:, n0:n0 + bn], vp[:, n0:n0 + bn]
        s = qp @ kt.transpose(0, 2, 1)
        dpr = gp @ vt.transpose(0, 2, 1)
        p = np.exp2(s * c + nlse[..., None])
        p[..., n0 + np.arange(bn) >= t] = 0.0
        ds = rnd(p * (dpr - dl[..., None]) * np.float32(scale))
        dq += ds @ kt
    return rnd(dq[:, :t, :dh]), delta


def emulate_dkv(q, k, v, g, lse, delta, scale, rnd=_no_round):
    """dk and dv of the dK/dV kernel's loop."""
    bh, t, dh = q.shape
    dp, bn = _shape(dh)
    kp, vp = _tiles(k, 128, dp), _tiles(v, 128, dp)
    qp, gp = _tiles(q, bn, dp), _tiles(g, bn, dp)
    cols = qp.shape[1]
    nlse = np.zeros((bh, cols), np.float32)
    nlse[:, :t] = -lse * LOG2E
    dl = np.zeros((bh, cols), np.float32)
    dl[:, :t] = delta
    c = np.float32(scale) * LOG2E
    key_ok = (np.arange(kp.shape[1]) < t)[None, :, None]
    dk, dv = np.zeros_like(kp), np.zeros_like(vp)
    for m0 in range(0, cols, bn):
        qt, gt = qp[:, m0:m0 + bn], gp[:, m0:m0 + bn]
        st = kp @ qt.transpose(0, 2, 1)
        dpt = vp @ gt.transpose(0, 2, 1)
        p = np.where(key_ok, np.exp2(st * c + nlse[:, None, m0:m0 + bn]), 0.0).astype(np.float32)
        hi = rnd(p)
        lo = rnd(p - hi)
        dv += hi @ gt + lo @ gt
        dk += rnd(p * (dpt - dl[:, None, m0:m0 + bn]) * np.float32(scale)) @ qt
    return rnd(dk[:, :t, :dh]), rnd(dv[:, :t, :dh])


def _flat(x):
    return np.asarray(x, np.float32).reshape(-1, *np.shape(x)[-2:])


@functools.cache
def _pallas_grads(t, dh):
    """(q, k, v, w) and the Pallas backward's (dq, dk, dv), interpret mode."""
    q, k, v, w = _qkvw(t, seed=100 + t + dh, dh=dh)
    fn = lambda q, k, v: (jax_flash.flash_attention(  # noqa: E731
        q, k, v, interpret=True, bwd_impl="pallas") * w).sum()
    grads = jax.grad(fn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return (q, k, v, w), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("t,dh", EMULATED)
def test_kernel_tile_loop_in_float32_matches_pallas_backward(t, dh):
    (q, k, v, w), want = _pallas_grads(t, dh)
    out, lse = port_flash.flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
    scale = dh ** -0.5
    args = [_flat(x) for x in (q, k, v, w)]
    dq, delta = emulate_dq(*args, _flat(out.numpy()), lse.numpy(), scale)
    dk, dv = emulate_dkv(*args, lse.numpy(), delta, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got.reshape(ref.shape), ref, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("t,dh", EMULATED)
def test_kernel_tile_loop_in_bfloat16_is_as_close_to_float32_as_plain_bfloat16(t, dh):
    """The kernels' rounding points against the bf16 plain version: each
    gradient's largest error against the float32 plain version on the same
    bf16-rounded inputs at most 1.5 times the plain bf16 version's (the
    card's check, chip_smoke.py K3_BF16_RATIO)."""
    q, k, v, w = (torch.from_numpy(_bf16(x)) for x in _qkvw(t, seed=200 + t + dh, dh=dh))

    def grads(*xs):
        leaves = [x.clone().requires_grad_(True) for x in xs[:3]]
        out, lse = port_flash.flash_attention_reference(*leaves)
        return out.detach(), lse.detach(), torch.autograd.grad(out, leaves, xs[3])

    out, lse, plain = grads(q.bfloat16(), k.bfloat16(), v.bfloat16(), w.bfloat16())
    _, _, exact = grads(q, k, v, w)
    scale = dh ** -0.5
    args = [_flat(x.numpy()) for x in (q, k, v, w)]
    dq, delta = emulate_dq(*args, _flat(out.float().numpy()), lse.numpy(), scale, rnd=_bf16)
    dk, dv = emulate_dkv(*args, lse.numpy(), delta, scale, rnd=_bf16)
    for name, got, p, e in zip(("dq", "dk", "dv"), (dq, dk, dv), plain, exact):
        e = e.numpy().reshape(got.shape)
        err = np.abs(got - e).max()
        plain_err = np.abs(p.float().numpy().reshape(got.shape) - e).max()
        assert err <= 1.5 * plain_err + 1e-6, (name, err, plain_err)


@functools.cache
def _pallas_forward(t, dh):
    """(q, k, v) and the Pallas forward's out and lse, interpret mode."""
    q, k, v, _ = _qkvw(t, seed=300 + t + dh, dh=dh)
    out, lse = jax_flash._flash_attention_fwd_impl(dh ** -0.5, True, *map(jnp.asarray, (q, k, v)))
    return (q, k, v), np.asarray(out), np.asarray(lse)[:, :t, 0]


@pytest.mark.parametrize("t,dh", FWD_EMULATED)
def test_forward_tile_loop_in_float32_matches_pallas_forward(t, dh):
    (q, k, v), want_out, want_lse = _pallas_forward(t, dh)
    out, lse = emulate_fwd(*(_flat(x) for x in (q, k, v)), dh ** -0.5)
    np.testing.assert_allclose(out.reshape(want_out.shape), want_out, rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(lse, want_lse, rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("t,dh", FWD_EMULATED)
def test_forward_tile_loop_in_bfloat16_is_as_close_to_float32_as_plain_bfloat16(t, dh):
    """out's largest error against the float32 plain version on the same
    bf16-rounded inputs at most 1.5 times the bf16 plain version's (the
    card's check), lse within 1e-4 of float32's."""
    q, k, v, _ = (torch.from_numpy(_bf16(x)) for x in _qkvw(t, seed=400 + t + dh, dh=dh))
    plain, _ = port_flash.flash_attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16())
    exact, exact_lse = port_flash.flash_attention_reference(q, k, v)
    out, lse = emulate_fwd(*(_flat(x.numpy()) for x in (q, k, v)), dh ** -0.5, rnd=_bf16)
    e = _flat(exact.numpy())
    err = np.abs(out - e).max()
    plain_err = np.abs(_flat(plain.float().numpy()) - e).max()
    assert err <= 1.5 * plain_err + 1e-6, (err, plain_err)
    np.testing.assert_allclose(lse, exact_lse.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("t,dh", FWD_EMULATED)
def test_forward_and_backward_tile_loops_in_float32_match_pallas_gradients(t, dh):
    """The three kernels end to end: the emulated forward's out and lse
    feed the emulated dQ and dK/dV loops."""
    (q, k, v, w), want = _pallas_grads(t, dh)
    args = [_flat(x) for x in (q, k, v, w)]
    scale = dh ** -0.5
    out, lse = emulate_fwd(*args[:3], scale)
    dq, delta = emulate_dq(*args, out, lse, scale)
    dk, dv = emulate_dkv(*args, lse, delta, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(got.reshape(ref.shape), ref, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("t,dh", FWD_EMULATED)
def test_forward_and_backward_tile_loops_in_bfloat16_are_as_close_as_plain_bfloat16(t, dh):
    """The bf16 forward's out and lse into the bf16 dQ and dK/dV loops:
    each gradient within 1.5 times the plain bf16 version's error against
    float32."""
    q, k, v, w = (torch.from_numpy(_bf16(x)) for x in _qkvw(t, seed=500 + t + dh, dh=dh))

    def grads(*xs):
        leaves = [x.clone().requires_grad_(True) for x in xs[:3]]
        out, _ = port_flash.flash_attention_reference(*leaves)
        return torch.autograd.grad(out, leaves, xs[3])

    plain = grads(q.bfloat16(), k.bfloat16(), v.bfloat16(), w.bfloat16())
    exact = grads(q, k, v, w)
    scale = dh ** -0.5
    args = [_flat(x.numpy()) for x in (q, k, v, w)]
    out, lse = emulate_fwd(*args[:3], scale, rnd=_bf16)
    dq, delta = emulate_dq(*args, out, lse, scale, rnd=_bf16)
    dk, dv = emulate_dkv(*args, lse, delta, scale, rnd=_bf16)
    for name, got, p, e in zip(("dq", "dk", "dv"), (dq, dk, dv), plain, exact):
        e = e.numpy().reshape(got.shape)
        err = np.abs(got - e).max()
        plain_err = np.abs(p.float().numpy().reshape(got.shape) - e).max()
        assert err <= 1.5 * plain_err + 1e-6, (name, err, plain_err)


def test_bf16_rounding_matches_torch():
    x = np.random.default_rng(8).standard_normal(10_000).astype(np.float32) * 1e3
    x[:4] = (1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0, 2.0 ** -130)  # ties both ways, subnormal
    assert np.array_equal(_bf16(x), torch.from_numpy(x).bfloat16().float().numpy())


@pytest.mark.parametrize("dh,box_rows,fwd_rows", [(16, 64, 256), (32, 64, 256), (48, 64, 256),
                                                  (64, 64, 256), (80, 32, 128), (128, 32, 128)])
def test_tma_geometry_of_the_models_layout(dh, box_rows, fwd_rows):
    """The (B, T, H*Dh) projections viewed as (B, H, T, Dh): dims innermost
    first, byte strides of T, H and B, the 64-column box."""
    b, h, t = 3, 5, 37
    x = torch.zeros((b, t, h * dh), dtype=torch.bfloat16).view(b, t, h, dh).transpose(1, 2)
    assert port_flash.bwd_box_rows(dh) == box_rows
    assert port_flash.fwd_block_rows(dh) == fwd_rows
    assert port_flash.tma_geometry(x, box_rows) == (
        dh, t, h, b, 2 * h * dh, 2 * dh, 2 * t * h * dh, 64, box_rows)
    y = x.contiguous()
    assert port_flash.tma_geometry(y, box_rows)[4:7] == (2 * dh, 2 * t * dh, 2 * h * t * dh)


def test_tma_geometry_gives_broadcast_size_one_dims_a_usable_stride():
    x = torch.zeros((1, 64, 64), dtype=torch.bfloat16).view(1, 1, 64, 64).expand(1, 1, 64, 64)
    x = x.as_strided((1, 1, 64, 64), (0, 0, 64, 1))
    assert port_flash.tma_geometry(x, 64) == (64, 64, 1, 1, 128, 16, 16, 64, 64)


def test_kernel_ready_copies_a_broadcast_dim():
    fa = port_flash.flash_attention
    before = fa.copies
    base = torch.zeros((1, 2, 8, 16))
    assert port_flash._kernel_ready(base.expand(3, 2, 8, 16)).is_contiguous()
    assert fa.copies == before + 1
    size_one = base.as_strided((1, 2, 8, 16), (0, 128, 16, 1))
    assert port_flash._kernel_ready(size_one) is size_one
    assert fa.copies == before + 1


def _unpacked(strides: bytes) -> list[int]:
    return list(struct.unpack(f"{len(strides) // 8}q", strides))


@pytest.fixture
def recorded_launches(monkeypatch):
    """launch_dq / launch_dkv on CPU tensors with `_launch` recording its
    arguments instead of calling the library."""
    calls = []
    monkeypatch.setattr(port_flash, "_launch", lambda *a: calls.append(a))
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_forward_passes_the_three_maps(recorded_launches, dtype):
    """The launch hands over q, k, v and out, whose strides the C launcher
    encodes the tensor maps from (q's, k's, v's and out's in bf16), no
    running state, and K3's own mode (read 0, final 1). One launch
    counted."""
    fa = port_flash.flash_attention
    for dh in (32, 80):
        q, k, v, _ = (torch.from_numpy(x).to(dtype) for x in _qkvw(70, seed=12, dh=dh))
        before = fa.fwd_launches
        out, lse = port_flash.launch_forward(q, k, v, 0.5)
        assert fa.fwd_launches == before + 1
        assert out.shape == q.shape and out.dtype == dtype and out.transpose(1, 2).is_contiguous()
        assert lse.shape == (B * H, 70) and lse.dtype == torch.float32
        which, name, tensors, strided, flags, scale = recorded_launches[-1]
        assert (which, name, scale) == (0, "forward", 0.5)
        assert tensors[:3] == (q, k, v) and tensors[3] is out and tensors[4] is lse
        assert tensors[5] is None and strided == (q, k, v, out, None)
        assert flags == (0, 1)
        assert _unpacked(port_flash._strides(*strided)) == [
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], 0, 0, 0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_dq_forms_or_takes_delta(recorded_launches, dtype):
    fa = port_flash.flash_attention
    q, k, v, w = (torch.from_numpy(x).to(dtype) for x in _qkvw(70, seed=9))
    out, lse = port_flash.flash_attention_reference(q, k, v)
    before = fa.bwd_dq_launches
    dq, delta = port_flash.launch_dq(q, k, v, w, out, lse, 0.5)
    assert dq.shape == q.shape and dq.dtype == dtype and dq.transpose(1, 2).is_contiguous()
    assert delta.shape == (B * H, 70) and delta.dtype == torch.float32
    which, name, tensors, strided, flags, scale = recorded_launches[-1]
    assert (which, name, scale) == (1, "dQ", 0.5)
    assert tensors[:6] == (q, k, v, w, out, lse) and tensors[6] is delta and tensors[7] is dq
    assert tensors[8] is None and strided == (q, k, v, w, out, dq, None)
    given, read, final = flags
    assert (read, final) == (0, 1)  # K3's own mode
    if dtype == torch.bfloat16:  # the kernel forms delta: its buffer, flag 0
        assert given == 0
    else:  # float32: row_delta's, handed to the kernel
        assert given == 1
        torch.testing.assert_close(delta, port_flash.row_delta(w, out).view(B * H, 70))
    mine = torch.ones((B * H, 70))
    _, passed = port_flash.launch_dq(q, k, v, w, out, lse, 0.5, delta=mine)
    assert passed is mine and recorded_launches[-1][4][0] == 1
    assert fa.bwd_dq_launches == before + 2


def test_launch_dkv_passes_delta_and_the_four_maps(recorded_launches):
    fa = port_flash.flash_attention
    q, k, v, w = (torch.from_numpy(x).bfloat16() for x in _qkvw(70, seed=10, dh=80))
    lse, delta = torch.zeros((B * H, 70)), torch.ones((B * H, 70))
    before = fa.bwd_dkv_launches
    dk, dv = port_flash.launch_dkv(q, k, v, w, lse, delta, 0.25)
    which, name, tensors, strided, flags, scale = recorded_launches[-1]
    assert (which, name, scale) == (2, "dK/dV", 0.25)
    assert tensors[4] is lse and tensors[5] is delta and tensors[6] is dk and tensors[7] is dv
    assert tensors[8:] == (None, None) and flags == (0, 1)
    assert strided[:4] == (q, k, v, w)  # the four maps' tensors, encoded in C
    assert dk.shape == dv.shape == q.shape and fa.bwd_dkv_launches == before + 1


@pytest.mark.parametrize("read,final", [(0, 0), (1, 0), (1, 1)])
def test_ring_modes_pass_their_running_state(recorded_launches, read, final):
    """The ring modes hand over the float32 running state with its strides
    and the two flags; the buffers a mode does not write may be None."""
    fa = port_flash.flash_attention
    q, k, v, w = (torch.from_numpy(x).bfloat16() for x in _qkvw(70, seed=13))
    out, lse = port_flash._empty_bthd(q), torch.zeros((B * H, 70))
    run = port_flash._empty_bthd(q, torch.float32)
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    port_flash.forward_step(q, k, v, 0.5, out, lse, run, bool(read), bool(final))
    _, _, tensors, strided, flags, _ = recorded_launches[-1]
    assert tensors[5] is run and strided[4] is run and flags == (read, final)
    delta = port_flash.dq_step(q, k, v, w, out, lse, 0.5, None, out, run, bool(read),
                               bool(final))
    _, _, tensors, strided, flags, _ = recorded_launches[-1]
    assert tensors[8] is run and strided[6] is run and flags == (0, read, final)
    acc = (torch.empty((B, 70, H, DH)), torch.empty((B, 70, H, DH)))
    port_flash.dkv_step(q, k, v, w, lse, delta, 0.5, None, None, acc[0].transpose(1, 2),
                        acc[1].transpose(1, 2), bool(read), False)
    _, _, tensors, strided, flags, _ = recorded_launches[-1]
    assert tensors[6:8] == (None, None) and flags == (read, 0)
    assert [x.data_ptr() for x in tensors[8:]] == [a.data_ptr() for a in acc]
    assert _unpacked(port_flash._strides(*strided))[12:] == [0] * 6 + [
        70 * H * DH, DH, H * DH] * 2
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == tuple(
        n + 1 for n in before)


@pytest.mark.parametrize("need", ["qkv", "kv", "q"])
def test_autograd_function_backward_on_the_emulated_kernels(monkeypatch, need):
    """_FlashAttention's own backward, with the launches replaced by the
    numpy emulation above (float32): which passes run, where delta comes
    from, and the gradients against autograd through the plain version.
    Without dq the dQ pass is skipped and delta is row_delta's."""
    calls = []

    def fake_forward(q, k, v, scale):
        out, lse = port_flash.flash_attention_reference(q, k, v, scale)
        return out.detach(), lse.detach()

    def fake_dq(q, k, v, g, out, lse, scale, delta=None):
        calls.append("dq")
        assert delta is None
        dq, delta = emulate_dq(*(_flat(x.numpy()) for x in (q, k, v, g, out)), lse.numpy(), scale)
        return torch.from_numpy(dq).view(q.shape), torch.from_numpy(delta)

    def fake_dkv(q, k, v, g, lse, delta, scale):
        calls.append("dkv")
        want = port_flash.row_delta(g, out_ref).reshape(delta.shape)
        torch.testing.assert_close(delta, want, rtol=1e-5, atol=1e-6)
        dk, dv = emulate_dkv(*(_flat(x.numpy()) for x in (q, k, v, g)), lse.numpy(),
                             delta.reshape(lse.shape).numpy(), scale)
        return torch.from_numpy(dk).view(q.shape), torch.from_numpy(dv).view(q.shape)

    monkeypatch.setattr(port_flash, "launch_forward", fake_forward)
    monkeypatch.setattr(port_flash, "launch_dq", fake_dq)
    monkeypatch.setattr(port_flash, "launch_dkv", fake_dkv)
    q, k, v, w = (torch.from_numpy(x) for x in _qkvw(130, seed=11))
    out_ref, _ = fake_forward(q, k, v, DH ** -0.5)
    mine = [x.clone().requires_grad_(n in need) for x, n in zip((q, k, v), "qkv")]
    ref = [x.clone().requires_grad_(n in need) for x, n in zip((q, k, v), "qkv")]
    out, _ = port_flash._FlashAttention.apply(*mine, DH ** -0.5)
    want, _ = port_flash.flash_attention_reference(*ref)
    wanted = [x for x in ref if x.requires_grad]
    got = torch.autograd.grad(out, [x for x in mine if x.requires_grad], w)
    for a, r in zip(got, torch.autograd.grad(want, wanted, w)):
        torch.testing.assert_close(a, r, **GRAD_TOL)
    assert calls == {"qkv": ["dq", "dkv"], "kv": ["dkv"], "q": ["dq"]}[need]
