"""The flagship's dtype and memory options in the port, on the CPU:
`model.norm_dtype=bfloat16` against flax with the same option (single
norms, the small flagship and Conformer), and
`model.remat=resnet|conformer|all` against `remat=none` in train mode with
dropout on, which holds the recompute to the masks and the BatchNorm
statistics of the forward."""

import contextlib

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import Config, parse_overrides
from seld_tpu.models import build_model
from seld_tpu_torch import config as pc
from seld_tpu_torch.losses import SELDLossFn
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.models import layers as port_layers
from seld_tpu_torch.train.optimizer import make_optimizer
from seld_tpu_torch.train.state import create_train_state
from seld_tpu_torch.train.steps import make_train_step
from tests.test_torch_backbones import port_model, random_variables, two_pass_variance
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

FLAGSHIP = ["model.resnet_conf_d_model=32", "model.resnet_conf_n_heads=2",
            "model.resnet_conf_n_layers=1"]
CONFORMER = ["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
             "model.conf_d_model=32", "model.conf_n_heads=4", "model.conf_n_layers=2"]
BF16_NORMS = ["model.compute_dtype=float32", "model.norm_dtype=bfloat16"]
B, T = 2, 6


def _bf16_values(shape, seed, scale=2.0, shift=1.0):
    """float32 numbers that bf16 holds exactly, so both sides read one input."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale + shift
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


# --- the norms ------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_bf16_batchnorm_matches_flax(train):
    """flax's BatchNorm(dtype=bfloat16): float32 statistics and arithmetic,
    the result cast to bf16. The port's equals it to one bf16 rounding
    (measured: bit-equal), keeps float32 running statistics and updates
    them with the biased variance as flax does."""
    rng = np.random.default_rng(4)
    x = _bf16_values((4, 6, 5, 8), 3)  # NHWC
    p = dict(scale=rng.uniform(0.5, 1.5, 8), bias=rng.normal(0, 0.1, 8))
    s = dict(mean=rng.normal(0, 0.1, 8), var=rng.uniform(0.5, 1.5, 8))
    p, s = ({k: v.astype(np.float32) for k, v in d.items()} for d in (p, s))
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.bfloat16)
    want, updates = bn.apply({"params": p, "batch_stats": s},
                             jnp.asarray(x, jnp.bfloat16), mutable=["batch_stats"])
    port = port_layers.BatchNorm(8, torch.bfloat16).train(train)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in dict(
        weight=p["scale"], bias=p["bias"], running_mean=s["mean"], running_var=s["var"]).items()})
    got = port(torch.tensor(x).bfloat16().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16 and port.running_var.dtype == torch.float32
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -8, atol=1e-6)
    for stat, buf in (("mean", port.running_mean), ("var", port.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(updates["batch_stats"][stat]),
                                   rtol=1e-5, atol=1e-6)


def test_bf16_layernorm_matches_flax():
    """flax's LayerNorm(dtype=bfloat16). The port hands F.layer_norm bf16
    scale and bias (CUDA's kernel takes no float32 weights with a bf16
    input), so a value may sit one bf16 rounding further off: at most
    2 ** -7 relative, or 2 ** -6 absolute for values below 2 (measured
    0.0156 at values near 4)."""
    rng = np.random.default_rng(5)
    x = _bf16_values((4, 6, 32), 6)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = rng.normal(0, 0.1, 32).astype(np.float32)
    want = nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jnp.bfloat16))
    port = port_layers.LayerNorm(32, torch.bfloat16)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    got = port(torch.tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -6)


@pytest.mark.parametrize("norm_dtype,dtype_in,dtype_out", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("train", [False, True])
def test_norms_return_their_norm_dtype(norm_dtype, dtype_in, dtype_out, train):
    x = torch.randn(2, 8, 5, 3, dtype=dtype_in)
    bn = port_layers.BatchNorm(8, norm_dtype).train(train)
    ln = port_layers.LayerNorm(3, norm_dtype).train(train)
    assert bn(x).dtype == ln(x).dtype == dtype_out
    assert all(t.dtype == torch.float32 for t in (*bn.parameters(), *bn.buffers(),
                                                  *ln.parameters()))


def _norm_outputs(model):
    """Hooks that record the dtype of every norm's output."""
    seen = []
    for m in model.modules():
        if isinstance(m, (port_layers.BatchNorm, port_layers.LayerNorm)):
            m.register_forward_hook(lambda mod, args, out: seen.append(out.dtype))
    return seen


@pytest.mark.parametrize("name,overrides,train,atol", [
    # eval mode through 54 norms: bf16 roundings of the same float32 values,
    # measured 0.026 on logits of scale 3
    ("flagship", FLAGSHIP, False, 6e-2),
    # measured 0.0084 (eval) and 0.0147 (train)
    ("conformer", CONFORMER, False, 3e-2),
    ("conformer", CONFORMER, True, 3e-2),
])
def test_bf16_norm_models_match_flax(name, overrides, train, atol, monkeypatch):
    """The model with norm_dtype=bfloat16 (compute float32, so the norms'
    roundings are the only bf16 in it) against flax with the same option,
    every norm returning bf16. The flagship in train mode is left out:
    with batch statistics over 24 values a channel, flax's own logits move
    by 1.08 for a 1e-6 relative change of its input at this size, so no
    port could be held to it there."""
    cfg = parse_overrides(Config(), overrides + BF16_NORMS)
    model = build_model(cfg.model, cfg.grid).clone(dropout=0.0)
    variables = random_variables(model, jnp.zeros((B, T, 4, 64), jnp.float32))
    x = np.random.default_rng(7).standard_normal((B, T, 4, 64)).astype(np.float32)
    if train:
        two_pass_variance(monkeypatch)
        want = model.apply(variables, x, train=True, mutable=["batch_stats"])[0]
    else:
        want = model.apply(variables, x, train=False)
    port = port_model(variables, overrides + BF16_NORMS, dropout=0.0).train(train)
    seen = _norm_outputs(port)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert seen and set(seen) == {torch.bfloat16}
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


# --- remat ----------------------------------------------------------------


def _model(overrides, remat, dropout=0.3):
    field = "conf_dropout" if "conformer" in overrides[0] else "resnet_dropout"
    cfg = pc.parse_overrides(pc.Config(), [*overrides, "model.compute_dtype=float32",
                                           f"model.remat={remat}", f"model.{field}={dropout}"])
    return build_port_model(cfg.model, cfg.grid, device="cpu", seed=3).train()


def _run(model, x, w, seed=11):
    """Train-mode output, parameter gradients and buffers of one forward
    and backward of a seeded linear functional, dropout seeded by `seed`."""
    model.zero_grad()
    model.seed_dropout(seed)
    out = model(x)
    (out * w).mean().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return out.detach(), grads, {k: b.clone() for k, b in model.named_buffers()}


def _count_calls(model, kind):
    """Calls of every `kind` block, counted as they start (the recompute
    stops as soon as it has what the backward needs, so it may never
    return)."""
    calls = []
    for m in model.modules():
        if isinstance(m, kind):
            m.register_forward_pre_hook(lambda *_: calls.append(1))
    return calls


REMAT_CASES = [("flagship", FLAGSHIP, "resnet"), ("flagship", FLAGSHIP, "conformer"),
               ("flagship", FLAGSHIP, "all"), ("conformer", CONFORMER, "conformer"),
               ("conformer", CONFORMER, "all")]


@pytest.mark.parametrize("name,overrides,remat", REMAT_CASES)
def test_remat_matches_plain_in_train_mode_with_dropout(name, overrides, remat):
    """remat against none, the same weights and dropout seed, train mode,
    dropout 0.3: outputs within 1e-5 and gradients within 1e-4, as
    tests/test_models.py holds the JAX package's remat; the running
    statistics updated once, not again by the recompute; the same
    state_dict layout; and the recompute really ran (each checkpointed
    block's forward twice)."""
    from seld_tpu_torch.models.resnet_conformer import BottleneckBlock

    x = torch.from_numpy(np.random.default_rng(8).standard_normal((B, T, 4, 64))
                         .astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(9).standard_normal((B, T, 14, 648))
                         .astype(np.float32))
    plain, checkpointed = _model(overrides, "none"), _model(overrides, remat)
    assert plain.state_dict().keys() == checkpointed.state_dict().keys()
    kind = BottleneckBlock if remat == "resnet" else port_layers.ConformerBlock
    n_blocks = sum(isinstance(m, kind) for m in plain.modules())
    calls = _count_calls(checkpointed, kind)
    out0, g0, b0 = _run(plain, x, w)
    out1, g1, b1 = _run(checkpointed, x, w)
    assert len(calls) == 2 * n_blocks
    np.testing.assert_allclose(out1.numpy(), out0.numpy(), atol=1e-5, rtol=0)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), atol=1e-4, rtol=0,
                                   err_msg=k)
    for k in b0:
        np.testing.assert_allclose(b1[k].numpy(), b0[k].numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_remat_without_replaying_the_masks_gives_other_gradients(monkeypatch):
    """The trap the recompute guards against: were the dropout generator
    not set back for the recompute, it would draw other masks and the
    gradients would be silently wrong. With the replay switched off the
    gradients move by more than ten times the 1e-4 above (measured 4e-3,
    on gradients of about 1e-2)."""

    @contextlib.contextmanager
    def stats_only(block, generator, start):  # holds the statistics, not the masks
        norms = [m for m in block.modules() if isinstance(m, port_layers.BatchNorm)]
        for m in norms:
            m.update_stats = False
        try:
            yield
        finally:
            for m in norms:
                m.update_stats = True

    x = torch.from_numpy(np.random.default_rng(8).standard_normal((B, T, 4, 64))
                         .astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(9).standard_normal((B, T, 14, 648))
                         .astype(np.float32))
    _, g0, _ = _run(_model(CONFORMER, "none"), x, w)
    monkeypatch.setattr(port_layers, "_replaying", stats_only)
    _, g1, _ = _run(_model(CONFORMER, "conformer"), x, w)
    worst = max((g1[k] - g0[k]).abs().max().item() for k in g0)
    assert worst > 10 * 1e-4


def test_train_step_with_remat_equals_plain():
    """One optimizer step of the train step (dropout on, K2's plain version
    on the CPU) with remat=all against remat=none: the same loss and the
    same updated parameters and statistics."""
    cfg = pc.parse_overrides(pc.Config(), CONFORMER)
    mel = torch.from_numpy(np.random.default_rng(12).standard_normal((B, T, 4, 64))
                           .astype(np.float32))
    mask = torch.from_numpy(np.random.default_rng(13).integers(
        0, 2 ** 13, (B, T, 648)).astype(np.int16))
    results = []
    for remat in ("none", "all"):
        model = _model(CONFORMER, remat)
        optimizer = make_optimizer(model.parameters(), 1e-3, 1e-4)
        step = make_train_step(model, SELDLossFn(cfg.loss, cfg.grid), optimizer,
                               cfg.grid.num_classes)
        _, metrics = step(create_train_state(model, optimizer), mel, mask, None, (0, 1))
        results.append((metrics["loss"].item(), model.state_dict()))
    (loss0, state0), (loss1, state1) = results
    assert np.isfinite(loss0) and abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    for k in state0:
        np.testing.assert_allclose(state1[k].numpy(), state0[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("field,value,err", [
    ("model.remat", "everything", ValueError),
    ("model.norm_dtype", "float16", ValueError),
    ("model.param_dtype", "float16", ValueError)])
def test_build_model_refuses_what_it_does_not_have(field, value, err):
    cfg = pc.parse_overrides(pc.Config(), [f"{field}={value}"])
    with pytest.raises(err):
        build_port_model(cfg.model, device="meta", seed=None)


@pytest.mark.parametrize("remat", ["none", "resnet", "conformer", "all"])
@pytest.mark.parametrize("norm_dtype", ["float32", "bfloat16"])
def test_default_flagship_builds_with_every_option(remat, norm_dtype):
    """The default-width flagship (on the meta device: shapes only) with
    each option keeps the plain model's state_dict layout, and
    `cspdarknet` builds the CSPDarkNet as `cnn` does."""
    def keys(*overrides):
        cfg = pc.parse_overrides(pc.Config(), list(overrides))
        return {k: tuple(v.shape) for k, v in
                build_port_model(cfg.model, device="meta", seed=None).state_dict().items()}

    assert keys(f"model.remat={remat}", f"model.norm_dtype={norm_dtype}") == keys()
    assert keys("model.model_type=cspdarknet") == keys("model.model_type=cnn")
