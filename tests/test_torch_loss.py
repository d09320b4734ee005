"""The port's grid losses, bitmask targets and the plain version of kernel
K2 against seld_tpu's, on the CPU: the same seeded numpy inputs go through
both packages. Values agree to rtol 1e-5 and gradients with respect to the
logits to rtol 2e-4 (float32 softmax and sums in another order), the
tolerances tests/test_pallas_kernels.py holds the Pallas kernel to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import GridConfig, LossConfig
from seld_tpu.losses import SELDLossFn
from seld_tpu.losses import seld_loss as jax_losses
from seld_tpu.ops.loss_pallas import grid_loss_terms as jax_grid_loss_terms
from seld_tpu.targets import rasterize as jax_raster
from seld_tpu_torch.config import GridConfig as PortGridConfig
from seld_tpu_torch.config import LossConfig as PortLossConfig
from seld_tpu_torch.losses import SELDLossFn as PortLossFn
from seld_tpu_torch.losses import seld_loss as port_losses
from seld_tpu_torch.ops import loss_cuda
from seld_tpu_torch.targets import rasterize as port_raster
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

VALUE_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
M = 14
LOSS_CONFIGS = {
    "mse": dict(loss_type="mse"),
    "mse_aiur_cl": dict(loss_type="mse", use_aiur=True, use_cl=True, w_aiur=0.7, w_cl=0.4),
    "ce": dict(loss_type="ce"),
}


def loss_case(seed, b=3, t=4, g=72):
    """Class-major logits (b, t, M, g), a uint16 bitmask with 90 %
    background cells and random event bits elsewhere (several per cell,
    bit 12 among them), and an example mask that zeroes the last row."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, M, g)).astype(np.float32)
    mask = np.where(rng.random((b, t, g)) < 0.9, 0,
                    rng.integers(1, 2 ** (M - 1), (b, t, g))).astype(np.uint16)
    mask[0, 0, :4] = [1 << 12, (1 << 12) | 1, 0b1010, 0]
    em = np.ones(b, np.float32)
    em[-1] = 0.0
    return logits, mask, em


def port_mask(mask_np):
    """The bitmask as the port's batches carry it: the same bits as int16."""
    return torch.from_numpy(mask_np.view(np.int16))


def port_value_and_grad(fn, logits_np):
    x = torch.from_numpy(logits_np).requires_grad_(True)
    total = fn(x)
    (grad,) = torch.autograd.grad(total, x)
    return total.item(), grad.numpy()


@pytest.mark.parametrize("name", LOSS_CONFIGS)
@pytest.mark.parametrize("form", ["dense", "bitmask"])
def test_composite_loss_matches_jax(name, form):
    grid, pgrid = GridConfig(cell_degrees=30), PortGridConfig(cell_degrees=30)
    logits, mask, em = loss_case(0, g=grid.n_cells)
    jfn = SELDLossFn(LossConfig(**LOSS_CONFIGS[name]), grid)
    pfn = PortLossFn(PortLossConfig(**LOSS_CONFIGS[name]), pgrid)
    if form == "dense":
        jt = jax_raster.decode_class_bitmask(jnp.asarray(mask), M, class_major=True)
        pt = port_raster.decode_class_bitmask(port_mask(mask), M, class_major=True)
        jcall = lambda lg: jfn(lg, jt, jnp.asarray(em))
        pcall = lambda lg: pfn(lg, pt, torch.from_numpy(em))
    else:
        jcall = lambda lg: jfn.from_bitmask(lg, jnp.asarray(mask), jnp.asarray(em), fused=False)
        pcall = lambda lg: pfn.from_bitmask(lg, port_mask(mask), torch.from_numpy(em))
    want, want_grad = jax.value_and_grad(lambda lg: jcall(lg).total)(jnp.asarray(logits))
    got, got_grad = port_value_and_grad(lambda lg: pcall(lg).total, logits)
    np.testing.assert_allclose(got, float(want), **VALUE_TOL)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), **GRAD_TOL)
    assert np.abs(got_grad[-1]).max() == 0.0  # the masked-out row adds nothing
    jbd = jcall(jnp.asarray(logits)).breakdown
    pbd = pcall(torch.from_numpy(logits)).breakdown
    assert set(jbd) == set(pbd)
    for k in jbd:
        np.testing.assert_allclose(pbd[k].item(), float(jbd[k]), **VALUE_TOL)


@pytest.mark.parametrize("term", ["mse", "ce", "aiur", "cl"])
@pytest.mark.parametrize("form", ["dense", "bitmask"])
def test_loss_term_matches_jax(term, form):
    logits, mask, em = loss_case(1, g=72)
    n_el, n_az = 6, 12
    jm, pm = jnp.asarray(mask), port_mask(mask)
    jt = jax_raster.decode_class_bitmask(jm, M, class_major=True)
    pt = port_raster.decode_class_bitmask(pm, M, class_major=True)
    jx, px = jnp.asarray(logits), torch.from_numpy(logits)
    jem, pem = jnp.asarray(em), torch.from_numpy(em)
    jw, pw = jax_losses.make_class_weights(M, 0.05), port_losses.make_class_weights(M, 0.05)
    calls = {
        ("mse", "dense"): (lambda: jax_losses.class_mse_loss(jx, jt, jem),
                           lambda: port_losses.class_mse_loss(px, pt, pem)),
        ("mse", "bitmask"): (lambda: jax_losses.class_mse_loss_bits(jx, jm, M, jem),
                             lambda: port_losses.class_mse_loss_bits(px, pm, M, pem)),
        ("ce", "dense"): (lambda: jax_losses.class_ce_loss(jx, jt, jw, jem),
                          lambda: port_losses.class_ce_loss(px, pt, pw, pem)),
        ("ce", "bitmask"): (lambda: jax_losses.class_ce_loss_bits(jx, jm, M, jw, jem),
                            lambda: port_losses.class_ce_loss_bits(px, pm, M, pw, pem)),
        ("aiur", "dense"): (lambda: jax_losses.aiur_loss(jx, jt, jem),
                            lambda: port_losses.aiur_loss(px, pt, pem)),
        ("aiur", "bitmask"): (lambda: jax_losses.aiur_loss_bits(jx, jm, jem),
                              lambda: port_losses.aiur_loss_bits(px, pm, pem)),
        ("cl", "dense"): (
            lambda: jax_losses.converging_localization_loss(jx, jt, n_el, n_az, example_mask=jem),
            lambda: port_losses.converging_localization_loss(px, pt, n_el, n_az, example_mask=pem)),
        ("cl", "bitmask"): (
            lambda: jax_losses.converging_localization_loss_bits(jx, jm, n_el, n_az, jem),
            lambda: port_losses.converging_localization_loss_bits(px, pm, n_el, n_az, pem)),
    }
    jcall, pcall = calls[term, form]
    np.testing.assert_allclose(pcall().item(), float(jcall()), **VALUE_TOL)


def test_terms_without_example_mask_match_jax():
    logits, mask, _ = loss_case(2, g=72)
    want = jax_losses.class_mse_loss_bits(jnp.asarray(logits), jnp.asarray(mask), M)
    got = port_losses.class_mse_loss_bits(torch.from_numpy(logits), port_mask(mask), M)
    np.testing.assert_allclose(got.item(), float(want), **VALUE_TOL)


def test_plain_k2_forward_matches_pallas_interpret():
    logits, mask, _ = loss_case(3, b=2, t=5, g=648)
    x = logits.reshape(10, M, 648)
    want_sq, want_bg = jax_grid_loss_terms(
        jnp.asarray(x), jnp.asarray(mask.reshape(10, 648)), M, True)
    sq, bg = loss_cuda.grid_loss_terms(
        torch.from_numpy(x), port_mask(mask).reshape(10, 648), M)
    np.testing.assert_allclose(sq.numpy(), np.asarray(want_sq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bg.numpy(), np.asarray(want_bg), rtol=1e-5, atol=1e-7)


def test_plain_k2_gradient_matches_pallas_interpret():
    """d/dlogits of a functional of both outputs, as
    tests/test_pallas_kernels.py holds the Pallas kernel to its oracle."""
    logits, mask, _ = loss_case(4, b=2, t=3, g=648)
    n = 6
    w = np.random.default_rng(5).standard_normal((n, 648)).astype(np.float32)

    def jax_fn(lg):
        sq, bg = jax_grid_loss_terms(lg.reshape(n, M, 648),
                                     jnp.asarray(mask.reshape(n, 648)), M, True)
        return jnp.sum(sq) * 0.3 + jnp.sum(bg * jnp.asarray(w))

    def port_fn(lg):
        sq, bg = loss_cuda.grid_loss_terms(lg.reshape(n, M, 648),
                                           port_mask(mask).reshape(n, 648), M)
        return sq.sum() * 0.3 + (bg * torch.from_numpy(w)).sum()

    want = jax.grad(jax_fn)(jnp.asarray(logits))
    _, got = port_value_and_grad(port_fn, logits)
    np.testing.assert_allclose(got, np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("name", ["mse", "mse_aiur_cl"])
@pytest.mark.parametrize("jax_fused", ["interpret", False])
@pytest.mark.parametrize("port_path", ["auto", "through_k2_wrapper"])
def test_from_bitmask_matches_jax_fused_and_unfused(name, jax_fused, port_path):
    """On the CPU fused=None takes the unfused ops; `_from_bitmask_fused`
    goes through K2's wrapper, which takes the plain version for a CPU
    tensor. Both agree with both JAX paths."""
    grid, pgrid = GridConfig(), PortGridConfig()
    logits, mask, em = loss_case(6, b=3, t=2, g=648)
    jfn = SELDLossFn(LossConfig(**LOSS_CONFIGS[name]), grid)
    pfn = PortLossFn(PortLossConfig(**LOSS_CONFIGS[name]), pgrid)
    want, want_grad = jax.value_and_grad(
        lambda lg: jfn.from_bitmask(lg, jnp.asarray(mask), jnp.asarray(em),
                                    fused=jax_fused).total)(jnp.asarray(logits))
    call = pfn.from_bitmask if port_path == "auto" else pfn._from_bitmask_fused
    got, got_grad = port_value_and_grad(
        lambda lg: call(lg, port_mask(mask), torch.from_numpy(em)).total, logits)
    np.testing.assert_allclose(got, float(want), **VALUE_TOL)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), **GRAD_TOL)


def test_from_bitmask_auto_on_cpu_is_the_unfused_path(monkeypatch):
    calls = []
    monkeypatch.setattr(port_losses, "grid_loss_terms", lambda *a: calls.append(a))
    logits, mask, em = loss_case(7, b=2, t=2, g=648)
    pfn = PortLossFn(PortLossConfig(), PortGridConfig())
    auto = pfn.from_bitmask(torch.from_numpy(logits), port_mask(mask))
    unfused = pfn.from_bitmask(torch.from_numpy(logits), port_mask(mask), fused=False)
    assert not calls and auto.total.item() == unfused.total.item()


def test_fused_values_the_port_does_not_take():
    logits, mask, _ = loss_case(8, b=2, t=2, g=648)
    pfn = PortLossFn(PortLossConfig(), PortGridConfig())
    with pytest.raises(ValueError, match="CUDA"):
        pfn.from_bitmask(torch.from_numpy(logits), port_mask(mask), fused=True)
    with pytest.raises(ValueError, match="None, False or True"):
        pfn.from_bitmask(torch.from_numpy(logits), port_mask(mask), fused="interpret")
    with pytest.raises(ValueError, match="loss_type"):
        PortLossFn(PortLossConfig(loss_type="huber"), PortGridConfig())


def test_plain_k2_gradcheck_float64():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 5, 4))).requires_grad_(True)
    mask = torch.tensor([[0, 1, 0b1010, 0b1000]] * 3, dtype=torch.int16)
    assert torch.autograd.gradcheck(
        lambda lg: loss_cuda.grid_loss_terms_reference(lg, mask, 5), (x,))


@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.int32, np.int64])
def test_k2_wrapper_takes_every_16_bit_or_wider_integer_mask(dtype):
    logits, mask, _ = loss_case(10, b=1, t=3, g=648)
    x = torch.from_numpy(logits[0])
    want = loss_cuda.grid_loss_terms(x, port_mask(mask)[0], M)
    got = loss_cuda.grid_loss_terms(x, torch.from_numpy(mask[0].astype(dtype)), M)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("make,err", [
    (lambda x, m: (x.bfloat16(), m), TypeError),  # no silent cast
    (lambda x, m: (x.transpose(0, 1).contiguous().transpose(0, 1), m), ValueError),
    (lambda x, m: (x, m.float()), TypeError),
    (lambda x, m: (x, m.to(torch.uint8)), TypeError),  # 13 bits need 16
    (lambda x, m: (x, m[:, :-1]), ValueError),
    (lambda x, m: (x[None], m), ValueError),
])
def test_k2_wrapper_checks_its_input(make, err):
    logits, mask, _ = loss_case(11, b=1, t=3, g=648)
    x, m = make(torch.from_numpy(logits[0]), port_mask(mask)[0])
    before = (loss_cuda.grid_loss_terms.fwd_launches, loss_cuda.grid_loss_terms.bwd_launches)
    with pytest.raises(err):
        loss_cuda.grid_loss_terms(x, m, M)
    assert (loss_cuda.grid_loss_terms.fwd_launches,
            loss_cuda.grid_loss_terms.bwd_launches) == before


def test_k2_wrapper_refuses_more_than_16_classes():
    x = torch.zeros((2, 17, 8))
    with pytest.raises(ValueError, match="2 to 16 classes"):
        loss_cuda.grid_loss_terms(x, torch.zeros((2, 8), dtype=torch.int16), 17)


def test_k2_wrapper_takes_plain_version_for_cpu_tensors(monkeypatch):
    calls = []
    plain = loss_cuda.grid_loss_terms_reference
    monkeypatch.setattr(loss_cuda, "grid_loss_terms_reference",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    before = loss_cuda.grid_loss_terms.fwd_launches
    sq, bg = loss_cuda.grid_loss_terms(torch.zeros((2, M, 8)),
                                       torch.zeros((2, 8), dtype=torch.int16), M)
    assert calls == [(2, M, 8)] and sq.shape == bg.shape == (2, 8)
    assert loss_cuda.grid_loss_terms.fwd_launches == before  # no kernel launched


@pytest.mark.parametrize("class_major", [False, True])
def test_decode_class_bitmask_equals_jax(class_major):
    _, mask, _ = loss_case(12)
    want = np.asarray(
        jax_raster.decode_class_bitmask(jnp.asarray(mask), M, class_major=class_major))
    for carried in (port_mask(mask), torch.from_numpy(mask.astype(np.int32))):
        got = port_raster.decode_class_bitmask(carried, M, class_major=class_major).numpy()
        np.testing.assert_array_equal(got, want)
    if not class_major:
        np.testing.assert_array_equal(port_raster.bitmask_to_dense(mask, M), want)


def test_bit_labels_and_popcount_equal_jax():
    _, mask, _ = loss_case(13)
    np.testing.assert_array_equal(
        port_losses._bit_labels(port_mask(mask), M).numpy(),
        np.asarray(jax_losses._bit_labels(jnp.asarray(mask), M)))
    np.testing.assert_array_equal(
        port_losses._popcount16(port_mask(mask).to(torch.int32)).numpy(),
        np.asarray(jax_losses._popcount16(jnp.asarray(mask).astype(jnp.int32))))


def test_encode_events_to_bitmask_equals_jax():
    rng = np.random.default_rng(14)
    n = 200
    frames = rng.integers(0, 30, n)
    classes = rng.integers(0, 13, n)
    az = rng.integers(-180, 181, n)  # the dateline at both ends
    el = rng.integers(-90, 91, n)  # both poles
    want = jax_raster.encode_events_to_bitmask(frames, classes, az, el, 140)
    got = port_raster.encode_events_to_bitmask(frames, classes, az, el, 140)
    assert got.dtype == np.uint16 and got.any()
    np.testing.assert_array_equal(got, want)
    assert (port_raster.total_label_frames(719_999, 24_000)
            == jax_raster.total_label_frames(719_999, 24_000) == 1499)
    empty = port_raster.encode_events_to_bitmask([], [], [], [], 7)
    assert empty.shape == (7, 648) and not empty.any()
