"""The port's attention against seld_tpu's, on the CPU: the plain version
of kernel K3 against the Pallas flash-attention kernels in interpret mode
(forward, logsumexp and the three gradients), the dispatch and its
`force_flash` override, and a conformer attention layer and the small
flagship at T = 512 against the JAX package running its flash kernels.
Inputs are seeded numpy arrays handed to both packages; weights cross
through seld_tpu_torch.convert.state_dict_from_jax."""

import functools

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


def _qkvw(t, seed, key_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, H, t, DH)).astype(np.float32) for _ in range(4))
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
