"""model.param_dtype=bfloat16 in the port against seld_tpu, on the CPU.

Every model type at a small width on converted bf16 JAX variables (eval
and train mode, the dtypes and the state_dict layout); `convert` carrying
bf16 leaves bit for bit; the bf16 Adam step against optax's chain; three
train steps and a QAT step of the small flagship against JAX's
`make_train_step`; the two combinations the JAX package cannot trace,
refused by name; the checkpoint manager's background saves and a bit-exact
bf16 resume; the parameter EMA and SWA against the JAX package's formulas;
int8 trees from bf16 weights; a bf16 teacher distilling into a float32
student; `import-torch` under a bf16 config; predict against the JAX
predictor; and a tiny bf16 CRNN through `cli train` -> `eval` ->
`predict` -> `export` -> the daemon. Inputs are seeded numpy arrays handed
to both packages. Each test removes what it writes."""

import copy
import shutil
import threading
import time
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu import quant as jq
from seld_tpu.config import Config, GridConfig, LossConfig, parse_overrides
from seld_tpu.losses import SELDLossFn
from seld_tpu.models import build_model
from seld_tpu.train.optimizer import make_optimizer
from seld_tpu.train.state import TrainState
from seld_tpu.train.steps import make_eval_step, make_train_step
from seld_tpu_torch import config as pc
from seld_tpu_torch import quant
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.convert import quant_tree_from_jax, state_dict_from_jax
from seld_tpu_torch.losses import SELDLossFn as PortLossFn
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.train import checkpoint as port_checkpoint
from seld_tpu_torch.train import optimizer as port_optimizer
from seld_tpu_torch.train.checkpoint import CheckpointManager
from seld_tpu_torch.train.state import create_train_state as create_port_state
from seld_tpu_torch.train.steps import make_eval_step as make_port_eval_step
from seld_tpu_torch.train.steps import make_train_step as make_port_train_step
from seld_tpu_torch.train.trainer import ema_update
from tests.test_torch_backbones import port_model, random_variables, two_pass_variance
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import port_fails

BF16 = ["model.param_dtype=bfloat16"]
TINY = {
    "crnn": ["model.model_type=crnn", "model.crnn_cnn_channels=8,16",
             "model.crnn_rnn_hidden=16", "model.crnn_rnn_layers=2"],
    "conformer": ["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                  "model.conf_d_model=32", "model.conf_n_heads=4", "model.conf_n_layers=1"],
    "resnet_conformer": ["model.resnet_conf_d_model=32", "model.resnet_conf_n_heads=2",
                         "model.resnet_conf_n_layers=1"],
    "cnn": ["model.model_type=cnn"],  # CSPDarkNet at its small default widths
    "accdoa_conformer": ["model.model_type=accdoa_conformer", "model.crnn_cnn_channels=8,16",
                         "model.conf_d_model=16", "model.conf_n_heads=2",
                         "model.conf_n_layers=1"],
    "multi_accdoa_conformer": ["model.model_type=multi_accdoa_conformer",
                               "model.crnn_cnn_channels=8,16", "model.conf_d_model=16",
                               "model.conf_n_heads=2", "model.conf_n_layers=1"],
}
B, T = 2, 6
# float32 compute: the float32 backbone tests' bars (tests/test_torch_backbones.py),
# since a bf16 weight is exact in float32. bf16 compute: the bf16-compute tests'
# bars, 0.05 absolute (tests/test_torch_backbones.py's CRNN, tests/test_torch_accdoa.py)
# and, against flax's float32-compute output on the same weights, an RMS error at
# most 1.5x flax's own bf16 error (tests/test_torch_accdoa.py). Measured (recorded by
# the test): 0.012-0.036 absolute and 0.93-1.14x, the CRNN 0.023; the flagship's 50
# bf16 layers 0.0605 on logits of scale 3.1 and 1.04x, held to 0.1 absolute.
F32_ATOL, F32_RTOL = 5e-4, 1e-3
BF16_ATOL = {"resnet_conformer": 0.1}
BF16_ATOL_DEFAULT = 5e-2
BF16_RMS_RATIO = 1.5
STEP_RTOL = 1e-2  # bf16 train steps: see test_three_bf16_train_steps_match_jax


@pytest.fixture(autouse=True)
def remove_what_the_test_wrote(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def bf16_tree(tree):
    """A numpy tree with every leaf rounded to bf16 as jnp.astype rounds
    (numpy leaves of ml_dtypes' bfloat16)."""
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)


def bf16_variables(model, seed=0, batch=B, frames=T):
    """random_variables of the bf16-parameter JAX model: params rounded to
    bf16 (the tree a bf16 flax model holds), batch_stats float32."""
    v = random_variables(model, jnp.zeros((batch, frames, 4, 64), jnp.float32), seed)
    return {"params": bf16_tree(v["params"]), "batch_stats": v["batch_stats"]}


def _input(seed, batch=B, frames=T):
    return np.random.default_rng(seed).standard_normal((batch, frames, 4, 64)).astype(
        np.float32)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 units in the last place (+0 and -0 are one value)."""
    def ordered(t):
        i = t.view(torch.int16).int() & 0xFFFF
        return torch.where(i >= 0x8000, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


# --- the models ------------------------------------------------------------------------

MODEL_CASES = [(m, c) for m in TINY for c in ("float32", "bfloat16")
               if not (m == "crnn" and c == "float32")]


@pytest.mark.parametrize("model_type,compute", MODEL_CASES,
                         ids=[f"{m}-{c}" for m, c in MODEL_CASES])
def test_bf16_parameter_models_match_flax(model_type, compute, record_property):
    """Eval logits of each model type on the same bf16 variables against
    flax with param_dtype=bfloat16; every parameter bf16, every running
    statistic float32, the state_dict's keys those of the float32 model."""
    overrides = TINY[model_type] + BF16 + [f"model.compute_dtype={compute}"]
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid)
    variables = bf16_variables(model)
    x = _input(1)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    port = port_model(variables, overrides)
    assert {p.dtype for p in port.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in port.buffers()} <= {torch.float32}
    f32 = pc.parse_overrides(pc.Config(), overrides[:-2] + [f"model.compute_dtype={compute}"])
    assert list(port.state_dict()) == list(
        build_port_model(f32.model, f32.grid, device="meta", seed=None).state_dict())
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    record_property("max_abs_diff", float(np.abs(got.numpy() - want).max()))
    if compute == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=F32_RTOL)
        return
    atol = BF16_ATOL.get(model_type, BF16_ATOL_DEFAULT)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    if model_type != "crnn":  # flax's float32 CRNN over bf16 weights does not init
        exact = np.asarray(jax.jit(lambda v, x: model.clone(dtype=jnp.float32).apply(
            v, x, train=False))(variables, x))

        def rms(a):
            return float(np.sqrt(np.mean(np.square(a - exact))))

        record_property("rms_ratio", rms(got.numpy()) / rms(want))
        assert rms(got.numpy()) <= BF16_RMS_RATIO * rms(want)


@pytest.mark.parametrize("model_type", ["conformer", "cnn", "accdoa_conformer"])
def test_bf16_parameter_train_mode_matches_flax(model_type, monkeypatch):
    """One train-mode forward at dropout 0 and float32 compute: logits to
    1e-4 and every updated BatchNorm statistic (float32) to 1e-5, against
    flax with a two-pass variance (tests/test_torch_backbones.py's bars).
    The flagship is left out, as in tests/test_torch_norm_remat.py: its
    train-mode logits at this size move by O(1) for a 1e-6 change."""
    overrides = TINY[model_type] + BF16 + ["model.compute_dtype=float32"]
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid).clone(dropout=0.0)
    variables = bf16_variables(model, seed=2)
    x = _input(2)
    two_pass_variance(monkeypatch)
    want, updates = jax.jit(lambda v, x: model.apply(v, x, train=True,
                                                     mutable=["batch_stats"]))(variables, x)
    port = port_model(variables, overrides, dropout=0.0).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    pcfg = pc.parse_overrides(pc.Config(), overrides).model
    want_state = state_dict_from_jax(
        jax.tree.map(np.asarray, {"params": variables["params"], **updates}), pcfg)
    stats = [k for k in want_state if "running_" in k]
    assert stats
    for k in stats:
        got_k = port.state_dict()[k]
        assert got_k.dtype == want_state[k].dtype == torch.float32
        np.testing.assert_allclose(got_k.numpy(), want_state[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_every_model_type_builds_bf16_and_initialises_by_rounding():
    """All seven model types: bf16 parameters, float32 statistics, and a
    seeded initialisation equal to the float32 model's draws rounded to
    nearest even (cspdarknet is cnn)."""
    for model_type, overrides in {**TINY, "cspdarknet": ["model.model_type=cspdarknet"]}.items():
        cfg = pc.parse_overrides(pc.Config(), overrides + BF16)
        f32 = pc.parse_overrides(pc.Config(), overrides)
        model = build_port_model(cfg.model, cfg.grid, device="cpu", seed=3)
        ref = build_port_model(f32.model, f32.grid, device="cpu", seed=3)
        got, want = model.state_dict(), ref.state_dict()
        assert list(got) == list(want), model_type
        for k, v in got.items():
            if "running_" in k:
                assert v.dtype == torch.float32 and torch.equal(v, want[k]), k
            else:
                assert v.dtype == torch.bfloat16, k
                assert torch.equal(v, want[k].to(torch.bfloat16)), k


def test_unknown_param_dtype_is_a_value_error():
    cfg = pc.parse_overrides(pc.Config(), ["model.param_dtype=float16"])
    with pytest.raises(ValueError, match="unknown param_dtype 'float16'"):
        build_port_model(cfg.model, device="meta", seed=None)


# --- the two refusals ------------------------------------------------------------------


def test_crnn_float32_compute_bf16_parameters_is_refused_where_flax_raises(tmp_path):
    """flax's GRU scan carries a bf16 carry in and a float32 one out: init
    raises TypeError when it is traced (seld_tpu/models/crnn.py:48; shown
    with jax.eval_shape, since on the CPU a real init of any bf16 CRNN fails
    before, in the orthogonal initializer's QR, which lapack has no bf16
    for). The port raises its named ValueError, in build_model and in `cli
    train` before any corpus."""
    overrides = TINY["crnn"] + BF16 + ["model.compute_dtype=float32"]
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid)
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                          jnp.zeros((1, 4, 4, 64)), train=False))
    pcfg = pc.parse_overrides(pc.Config(), overrides)
    with pytest.raises(ValueError, match=r"seld_tpu/models/crnn.py:48"):
        build_port_model(pcfg.model, pcfg.grid, device="meta", seed=None)
    port_fails(["train", "--synthetic", "--device", "cpu", f"data.base_path={tmp_path}",
                *overrides], ValueError, "raises TypeError at init")
    assert not list(tmp_path.iterdir())


def test_accumulation_with_bf16_parameters_is_refused_where_jax_raises(tmp_path):
    """JAX's accumulation adds share * gradient, a float32 sum of bf16
    gradients, and its scan raises TypeError (seld_tpu/train/steps.py:
    229-236). The port's make_train_step and `cli train` (before any corpus)
    raise the named ValueError."""
    overrides = TINY["conformer"] + BF16 + ["model.compute_dtype=float32"]
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid)
    variables = bf16_variables(model)
    tx = make_optimizer(1e-3, 1e-4)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=tx.init(
                           variables["params"]))
    jstep = make_train_step(model, SELDLossFn(LossConfig(), GridConfig()), tx, 14,
                            donate=False, accum_steps=2)
    mel, mask, em = _batch(3)
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(jstep, state, mel, mask, em, jax.random.PRNGKey(0))
    port = port_model(variables, overrides)
    opt = port_optimizer.make_optimizer(port.parameters(), 1e-3)
    with pytest.raises(ValueError, match=r"seld_tpu/train/steps.py:229-236"):
        make_port_train_step(port, PortLossFn(pc.LossConfig(), pc.GridConfig()), opt, 14,
                             accum_steps=2)
    port_fails(["train", "--synthetic", "--device", "cpu", f"data.base_path={tmp_path}",
                *overrides, "train.accum_steps=2"], ValueError, "train.accum_steps > 1")
    assert not list(tmp_path.iterdir())


# --- convert ---------------------------------------------------------------------------


def test_convert_carries_bf16_leaves_bit_for_bit_and_rounds_float32_as_astype():
    overrides = TINY["conformer"] + BF16
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid)
    f32 = random_variables(model, jnp.zeros((B, T, 4, 64), jnp.float32), seed=4)
    bf16 = {"params": bf16_tree(f32["params"]), "batch_stats": f32["batch_stats"]}
    leaf = bf16["params"]["proj"]["kernel"]
    assert leaf.dtype.name == "bfloat16" and type(leaf) is np.ndarray
    pcfg = pc.parse_overrides(pc.Config(), overrides).model
    carried = state_dict_from_jax(bf16, pcfg)
    rounded = state_dict_from_jax(f32, pcfg)  # a float32 tree for a bf16 config
    want = leaf.T.view(np.uint16)
    got = carried["proj.weight"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    for k, v in carried.items():
        assert v.dtype == rounded[k].dtype == (torch.float32 if "running_" in k
                                               else torch.bfloat16), k
        assert torch.equal(v, rounded[k]), k
    f32_cfg = pc.parse_overrides(pc.Config(), TINY["conformer"]).model
    assert all(v.dtype == torch.float32 for v in state_dict_from_jax(f32, f32_cfg).values())


# --- Adam --------------------------------------------------------------------------------


@pytest.mark.parametrize("weight_decay", [1e-4, 0.0])
def test_bf16_adam_step_equals_optax_chain(weight_decay, record_property):
    """Three steps of ChainAdam against seld_tpu's optax chain and
    p + u.astype(p.dtype) (seld_tpu/train/steps.py:251-253) from the same bf16
    parameters, with gradients of every magnitude and zero parameters
    (biases): every parameter and both moments within 1 bf16 ulp of optax's.
    Measured: all 200,000 entries bit-equal after each step, with and
    without weight decay (the share is recorded). torch.optim.Adam's share
    and largest ulp distance on the same steps are recorded beside it; it
    misses the bar where an update cancels a weight."""
    rng = np.random.default_rng(0)
    n = 200_000
    p0 = (rng.standard_normal(n) * 0.05).astype(np.float32)
    p0[:1000] = 0.0
    grads = [(rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 0, n)).astype(np.float32)
             for _ in range(3)]
    tx = make_optimizer(1e-3, weight_decay)
    params = {"w": jnp.asarray(p0, jnp.bfloat16)}
    opt_state = tx.init(params)

    @jax.jit
    def jstep(params, opt_state, g):
        u, opt_state = tx.update(g, opt_state, params)
        return jax.tree.map(lambda p, u: p + u.astype(p.dtype), params, u), opt_state

    p = torch.nn.Parameter(torch.from_numpy(p0).bfloat16())
    opt = port_optimizer.make_optimizer([p], 1e-3, weight_decay)
    assert isinstance(opt, port_optimizer.ChainAdam)
    # torch.optim.Adam on the same bf16 tensors, measured beside it: its
    # lerp, sqrt(nu) / sqrt(bias correction) and addcdiv round elsewhere
    q = torch.nn.Parameter(torch.from_numpy(p0).bfloat16())
    torch_adam = torch.optim.Adam([q], lr=1e-3, weight_decay=weight_decay, foreach=False)
    shares, torch_adam_ulps = [], []
    for g in grads:
        params, opt_state = jstep(params, opt_state, {"w": jnp.asarray(g, jnp.bfloat16)})
        p.grad, q.grad = torch.from_numpy(g).bfloat16(), torch.from_numpy(g).bfloat16()
        opt.step()
        torch_adam.step()
        adam = opt_state.inner_state[1]
        for got, want in ((p.detach(), params["w"]), (opt.state[p]["mu"], adam.mu["w"]),
                          (opt.state[p]["nu"], adam.nu["w"])):
            want = torch.from_numpy(np.array(want).view(np.int16)).view(torch.bfloat16)
            assert got.dtype == torch.bfloat16
            assert int(_ulps(got, want).max()) <= 1
        want_w = torch.from_numpy(np.array(params["w"]).view(np.int16)).view(torch.bfloat16)
        shares.append(float((_ulps(p.detach(), want_w) == 0).float().mean()))
        d = _ulps(q.detach(), want_w)
        torch_adam_ulps.append((float((d == 0).float().mean()), int(d.max())))
    record_property("bit_equal_share", shares)
    record_property("torch_adam_bit_equal_share_and_max_ulp", torch_adam_ulps)
    assert min(shares) >= 0.999
    assert opt.state[p]["step"] == 3


def test_chain_adam_schedules_and_state_dict():
    """set_learning_rate reaches the next step; the state_dict round-trips
    bf16 moments into a fresh optimizer that then steps bit-equal."""
    torch.manual_seed(0)
    p = torch.nn.Parameter(torch.randn(64).bfloat16())
    opt = port_optimizer.make_optimizer([p], 1e-3, 1e-4)
    p.grad = torch.randn(64).bfloat16()
    opt.step()
    port_optimizer.set_learning_rate(opt, 5e-4)
    assert port_optimizer.current_learning_rate(opt) == 5e-4
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = port_optimizer.make_optimizer([q], 1.0, 1e-4)
    opt2.load_state_dict(copy.deepcopy(opt.state_dict()))  # as from a file: no shared moments
    assert opt2.state[q]["mu"].dtype == torch.bfloat16 and opt2.state[q]["step"] == 1
    assert port_optimizer.current_learning_rate(opt2) == 5e-4
    g = torch.randn(64).bfloat16()
    p.grad, q.grad = g.clone(), g.clone()
    opt.step()
    opt2.step()
    assert torch.equal(p, q)


# --- the small flagship's train steps ----------------------------------------------------

SMALL = TINY["resnet_conformer"] + BF16 + ["model.resnet_dropout=0.0"]


def _batch(seed, n_valid=B):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, T, 4, 64)).astype(np.float32)
    mask = np.where(rng.random((B, T, 648)) < 0.9, 0,
                    rng.integers(1, 2 ** 13, (B, T, 648))).astype(np.uint16)
    em = (np.arange(B) < n_valid).astype(np.float32)
    return mel, mask, em


def _port_batch(mel, mask, em):
    return torch.from_numpy(mel), torch.from_numpy(mask.view(np.int16)), torch.from_numpy(em)


BATCHES = [_batch(10), _batch(11), _batch(12, n_valid=1)]


@pytest.fixture(scope="module")
def flagship():
    """(JAX small flagship with bf16 parameters and compute at dropout 0,
    its bf16 variables): the one ResNet50 the module builds."""
    cfg = parse_overrides(Config(), SMALL)
    model = build_model(cfg.model, cfg.grid)
    return model, bf16_variables(model, seed=7)


def _jax_state(variables):
    tx = make_optimizer(1e-3, 1e-4)
    return tx, TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))


def _port_steps(variables, qat=False, batches=BATCHES):
    port = port_model(variables, SMALL)
    opt = port_optimizer.make_optimizer(port.parameters(), 1e-3, 1e-4)
    loss_fn = PortLossFn(pc.LossConfig(), pc.GridConfig())
    step = make_port_train_step(port, loss_fn, opt, 14, qat=qat)
    state = create_port_state(port, opt)
    losses = [step(state, *_port_batch(*b), (0, 1))[1]["loss"].item() for b in batches]
    return port, loss_fn, losses


def test_three_bf16_train_steps_match_jax(flagship, record_property):
    """Loss per step, then the eval loss, of the small flagship with bf16
    parameters and bf16 compute against JAX's make_train_step from the same
    bf16 variables, at rtol 1e-2: bf16 products on both sides round apart
    (a loss of ~0.1 read to 8 bits), and three ChainAdam steps compound
    that (measured 4.3e-4, 3.5e-3, 4.2e-3, recorded); every gradient and
    moment stays bf16."""
    model, variables = flagship
    tx, state = _jax_state(variables)
    loss_fn = SELDLossFn(LossConfig(), GridConfig())
    jstep = make_train_step(model, loss_fn, tx, 14, donate=False)
    want = []
    for mel, mask, em in BATCHES:
        state, metrics = jstep(state, mel, mask, em, jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))
    assert {x.dtype for x in jax.tree.leaves(state.params)} == {jnp.dtype(jnp.bfloat16)}
    want_eval = float(make_eval_step(model, loss_fn, 14)(state, *BATCHES[0])["loss"])
    port, ploss, got = _port_steps(variables)
    assert np.isfinite(got).all()
    record_property("loss_rel_diff", [abs(g - w) / abs(w) for g, w in zip(got, want)])
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    assert {p.dtype for p in port.parameters()} == {torch.bfloat16}
    assert all(p.grad.dtype == torch.bfloat16 for p in port.parameters() if p.grad is not None)
    got_eval = make_port_eval_step(port, ploss, 14)(*_port_batch(*BATCHES[0]))["loss"].item()
    np.testing.assert_allclose(got_eval, want_eval, rtol=STEP_RTOL)


def test_bf16_qat_step_matches_jax(flagship, record_property):
    """One quantization-aware step (train.qat) from bf16 weights: JAX's QAT
    step with bf16 parameters runs, and the port's loss equals it at the
    bf16 steps' rtol (measured 4.1e-4, recorded); the weights stay bf16."""
    model, variables = flagship
    tx, state = _jax_state(variables)
    jstep = make_train_step(model, SELDLossFn(LossConfig(), GridConfig()), tx, 14,
                            donate=False, qat=True)
    state, metrics = jstep(state, *BATCHES[1], jax.random.PRNGKey(0))
    assert {x.dtype for x in jax.tree.leaves(state.params)} == {jnp.dtype(jnp.bfloat16)}
    port, _, got = _port_steps(variables, qat=True, batches=BATCHES[1:2])
    record_property("loss_rel_diff", abs(got[0] - float(metrics["loss"])) / float(metrics["loss"]))
    np.testing.assert_allclose(got[0], float(metrics["loss"]), rtol=STEP_RTOL)
    assert {p.dtype for p in port.parameters()} == {torch.bfloat16}


# --- checkpoints -------------------------------------------------------------------------

CKPT = TINY["conformer"] + BF16


def _trained(overrides=CKPT, steps=2, seed=0):
    """A port train state of the tiny conformer after `steps` Adam steps."""
    cfg = pc.parse_overrides(pc.Config(), overrides)
    model = build_port_model(cfg.model, cfg.grid, device="cpu", seed=seed)
    opt = port_optimizer.make_optimizer(model.parameters(), 1e-3, 1e-4)
    step = make_port_train_step(model, PortLossFn(pc.LossConfig(), pc.GridConfig()), opt, 14)
    state = create_port_state(model, opt)
    for i in range(steps):
        step(state, *_port_batch(*_batch(30 + i)), (0, 1))
    return cfg, state


def test_bf16_save_and_resume_is_bit_exact_at_half_the_bytes(tmp_path):
    """Parameters, moments and step read back bit for bit in bf16; the file
    is about half the float32 file of the same model."""
    cfg, state = _trained()
    mgr = CheckpointManager(tmp_path / "bf16", cfg)
    mgr.save_rolling(1, state, 0.5, 0.25)
    fresh_cfg, fresh = _trained(steps=0, seed=9)
    restored, meta = mgr.restore_latest(fresh)
    assert meta["epoch"] == 1 and restored.step == state.step == 2
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    a, b = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, s in a["state"].items():
        assert s["step"] == b["state"][i]["step"] == 2
        for key in ("mu", "nu"):
            assert s[key].dtype == torch.bfloat16 and torch.equal(s[key], b["state"][i][key])
    mgr.close()
    f32_cfg, f32_state = _trained(TINY["conformer"])
    mgr32 = CheckpointManager(tmp_path / "f32", f32_cfg)
    mgr32.save_rolling(1, f32_state, 0.5, 0.25)
    mgr32.close()
    size = next((tmp_path / "bf16" / "rolling").iterdir()).stat().st_size
    size32 = next((tmp_path / "f32" / "rolling").iterdir()).stat().st_size
    assert 0.45 < size / size32 < 0.55, (size, size32)


def test_saves_return_before_the_write_and_readers_wait(tmp_path, monkeypatch):
    """A writer held by the test: save_* returns with nothing on disk; the
    readers (best_meta, restore_latest, checkpoint_file,
    load_checkpoint_config) wait for it; rotation keeps N files; close
    stops the worker and a later save raises."""
    cfg, state = _trained(steps=1)
    cfg = cfg.replace_path("train.keep_last_n_checkpoints", 2)
    gate = threading.Event()
    write = port_checkpoint._write

    def held(path, blob):
        gate.wait(30)
        write(path, blob)

    monkeypatch.setattr(port_checkpoint, "_write", held)
    mgr = CheckpointManager(tmp_path, cfg)
    t0 = time.perf_counter()
    for epoch in (1, 2, 3):
        mgr.save_rolling(epoch, state, 0.5, 0.25)
    mgr.save_best(3, state, 0.5, 0.25)
    assert time.perf_counter() - t0 < 10
    assert not list(mgr.rolling_dir.iterdir()) and not list(mgr.best_dir.iterdir())
    threading.Timer(0.2, gate.set).start()
    assert port_checkpoint.load_checkpoint_config(tmp_path) == cfg  # waits for the writes
    assert sorted(f.name for f in mgr.rolling_dir.iterdir()) == ["epoch_0002.pt",
                                                                "epoch_0003.pt"]
    assert mgr.best_meta()["epoch"] == 3
    assert port_checkpoint.checkpoint_file(tmp_path, "latest").name == "epoch_0003.pt"
    mgr.close()
    mgr.close()  # closing twice is harmless
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save_rolling(4, state, 0.5, 0.25)
    assert not list(tmp_path.rglob("*.tmp"))


def test_snapshot_is_taken_before_save_returns(tmp_path, monkeypatch):
    """The file holds the state as it was at save_*, not as a later step
    left it while the write waited."""
    cfg, state = _trained(steps=1)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    gate = threading.Event()
    write = port_checkpoint._write
    monkeypatch.setattr(port_checkpoint, "_write",
                        lambda path, blob: (gate.wait(30), write(path, blob)))
    mgr = CheckpointManager(tmp_path, cfg)
    mgr.save_rolling(1, state, 0.5, 0.25)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    gate.set()
    mgr.wait()
    stored = torch.load(tmp_path / "rolling" / "epoch_0001.pt", weights_only=True)
    for k, v in want.items():
        assert torch.equal(stored["state_dict"][k], v), k
    mgr.close()


def test_a_failed_write_is_raised_by_the_next_call(tmp_path, monkeypatch):
    """A write that fails in the worker is raised by the next save_* (which
    then saves nothing), wait or close: never dropped."""
    cfg, state = _trained(steps=0)
    monkeypatch.setattr(port_checkpoint, "_write",
                        lambda path, blob: (_ for _ in ()).throw(OSError("disk gone")))
    mgr = CheckpointManager(tmp_path, cfg)
    for call in (lambda: mgr.save_rolling(2, state, 0.5, 0.25), mgr.wait, mgr.close):
        mgr.save_rolling(1, state, 0.5, 0.25)
        while mgr._pending and not mgr._pending[0].done():
            time.sleep(0.01)
        with pytest.raises(OSError, match="disk gone"):
            call()
    assert not list(tmp_path.rglob("*.pt"))


def test_a_write_that_dies_leaves_the_previous_file_whole(tmp_path, monkeypatch):
    cfg, state = _trained(steps=1)
    mgr = CheckpointManager(tmp_path, cfg)
    mgr.save_best(1, state, 0.5, 0.25)
    mgr.wait()
    path = tmp_path / "best" / "epoch_0001.pt"
    before = path.read_bytes()
    save = torch.save

    def dies(blob, f):
        Path(f).write_bytes(before[:100])  # a partial temporary file
        raise OSError("killed mid-write")

    monkeypatch.setattr(torch, "save", dies)
    mgr.save_best(1, state, 0.1, 0.1)
    with pytest.raises(OSError, match="mid-write"):
        mgr.wait()
    monkeypatch.setattr(torch, "save", save)
    assert path.read_bytes() == before and not list(tmp_path.rglob("*.tmp"))
    assert mgr.best_meta()["train_loss"] == 0.5
    mgr.close()


# --- EMA and SWA -------------------------------------------------------------------------


# the JAX trainer's update (seld_tpu/train/trainer.py:326), the decay a
# Python constant of the trace (static: one compile a decay)
EMA_UPDATE = jax.jit(lambda e, p, d: e * d + p.astype(e.dtype) * (1 - d), static_argnums=2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ema_equals_jax_formula(dtype, record_property):
    """Five steps of the trainer's EMA against seld_tpu/train/trainer.py:326's
    a * d + b.astype(a.dtype) * (1 - d), at decays 0.999 (which bf16 rounds
    to 1.0: only the live term moves a bf16 shadow, in both packages) and
    0.9: bf16 bit for bit; float32 within 2e-6 (XLA fuses the multiply-add
    on the CPU; measured 7.2e-7, about 1.5 ulp, on values up to 4; both
    recorded)."""
    rng = np.random.default_rng(3)
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    for decay in (0.999, 0.9):
        shadow = rng.standard_normal(5000).astype(np.float32)
        # copies on both sides: the update works in place, and a float32
        # jnp.asarray may share the numpy buffer that from_numpy shares
        want = jnp.array(shadow, jdtype)
        got = [torch.tensor(shadow).to(tdtype)]
        for _ in range(5):
            live = rng.standard_normal(5000).astype(np.float32)
            want = EMA_UPDATE(want, jnp.asarray(live, jdtype), decay)
            ema_update(got, [torch.from_numpy(live).to(tdtype)], decay)
        assert got[0].dtype == tdtype
        record_property(f"max_abs_diff_decay_{decay}",
                        float(np.abs(got[0].float().numpy() - np.asarray(want, np.float32)).max()))
        np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=0 if dtype == "bfloat16" else 2e-6)


def test_bf16_swa_equals_the_jax_tool(tmp_path):
    """`cli average-ckpts` over three bf16 rolling files against
    seld_tpu.tools.average_ckpt._mean_trees on the same arrays: the float64
    mean cast back to bf16, bit for bit; statistics stay float32."""
    from seld_tpu.tools.average_ckpt import _mean_trees

    cfg, state = _trained(steps=0)
    mgr = CheckpointManager(tmp_path / "run", cfg)
    sds = []
    for epoch in (1, 2, 3):
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(epoch))
                       .bfloat16() * 0.01)
        sds.append({k: v.clone() for k, v in state.model.state_dict().items()})
        mgr.save_rolling(epoch, state, 0.5, 0.25)
    mgr.close()
    assert port_main(["average-ckpts", "--checkpoint-dir", str(tmp_path / "run"),
                      "--output-dir", str(tmp_path / "swa"), *CKPT]) == 0
    blob = torch.load(next((tmp_path / "swa" / "best").iterdir()), weights_only=True)

    def to_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    want = _mean_trees([{k: to_jax(v) for k, v in sd.items()} for sd in sds])
    for k, v in blob["state_dict"].items():
        assert v.dtype == sds[0][k].dtype, k
        if v.dtype == torch.bfloat16:
            np.testing.assert_array_equal(v.view(torch.int16).numpy(),
                                          np.asarray(want[k]).view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)


# --- int8 --------------------------------------------------------------------------------


@pytest.mark.parametrize("weight_only", [False, True])
def test_int8_trees_from_bf16_weights_match_jax(weight_only):
    """PTQ and weight-only trees of the tiny conformer built from the same
    bf16 weights: w_q and s_w bit-equal (scales from the bf16 values read
    as float32), biases float32 and equal, s_x within 1e-2 relative (the
    calibration forwards run in bf16 on both sides)."""
    overrides = TINY["conformer"] + BF16
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid)
    variables = bf16_variables(model, seed=5)
    batches = [_input(6), _input(7)]
    jax_tree = jax.tree.map(np.asarray, jq.quantize_model(model, variables, batches,
                                                          weight_only=weight_only))
    port = port_model(variables, overrides)
    port_tree = quant.quantize_model(port, [torch.from_numpy(b) for b in batches],
                                     weight_only=weight_only)
    carried = quant_tree_from_jax(jax_tree, port.model_cfg)
    assert set(carried) == set(port_tree)
    for n, entry in port_tree.items():
        assert torch.equal(entry["w_q"], carried[n]["w_q"]), n
        assert torch.equal(entry["s_w"], carried[n]["s_w"]), n
        assert ("s_x" in entry) == (not weight_only)
        if "bias" in entry:
            assert entry["bias"].dtype == torch.float32
            assert torch.equal(entry["bias"], carried[n]["bias"]), n
        if not weight_only:
            np.testing.assert_allclose(float(entry["s_x"]), float(carried[n]["s_x"]),
                                       rtol=1e-2, err_msg=n)
    with torch.no_grad():
        out = quant.QuantizedModel(port, port_tree)(torch.from_numpy(batches[0]))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


# --- distillation ------------------------------------------------------------------------

CRNN_F32 = ["model.model_type=crnn", "model.crnn_cnn_channels=8,16",
            "model.crnn_rnn_hidden=16", "model.crnn_rnn_layers=1",
            "model.compute_dtype=float32"]
CONFORMER_BF16 = TINY["conformer"] + BF16 + ["model.compute_dtype=float32"]


@pytest.mark.parametrize("teacher_over,student_over", [(CONFORMER_BF16, CRNN_F32),
                                                       (CRNN_F32, CONFORMER_BF16)],
                         ids=["bf16_teacher", "bf16_student"])
def test_distilling_step_across_parameter_dtypes_matches_jax(teacher_over, student_over,
                                                             monkeypatch):
    """One distilling step with a bf16-parameter teacher and a float32
    student, and the reverse (a float32 CRNN teacher, a bf16-parameter
    Conformer student, which steps with ChainAdam): loss, hard and kd
    against JAX's distilling step at test_torch_distill.py's bar (rtol
    1e-3)."""
    from seld_tpu import distill as jd
    from seld_tpu.losses.seld_loss import make_class_weights as jax_class_weights
    from seld_tpu_torch import distill as pd
    from seld_tpu_torch.losses.seld_loss import make_class_weights

    def variables(model, overrides, seed):
        if BF16[0] in overrides:
            return bf16_variables(model, seed=seed)
        return random_variables(model, jnp.zeros((B, T, 4, 64), jnp.float32), seed)

    student = build_model(parse_overrides(Config(), student_over).model,
                          GridConfig()).clone(dropout=0.0)
    teacher = build_model(parse_overrides(Config(), teacher_over).model, GridConfig())
    s_vars, t_vars = variables(student, student_over, 1), variables(teacher, teacher_over, 2)
    tx = make_optimizer(1e-3, 1e-4)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=s_vars["params"],
                       batch_stats=s_vars["batch_stats"], opt_state=tx.init(s_vars["params"]))
    spec = jd.DistillSpec(apply=lambda v, x: teacher.apply(v, x, train=False),
                          kd=partial(jd.grid_kd_loss, class_weights=jax_class_weights(14, 0.05)),
                          alpha=0.5, temperature=2.0)
    two_pass_variance(monkeypatch)
    jstep = make_train_step(student, SELDLossFn(LossConfig(), GridConfig()), tx, 14,
                            donate=False, distill=spec)
    _, want = jstep(state, *BATCHES[0], jax.random.PRNGKey(0), t_vars)

    t_port = port_model(t_vars, teacher_over).requires_grad_(False).eval()
    s_port = port_model(s_vars, student_over, dropout=0.0)
    for model, over in ((t_port, teacher_over), (s_port, student_over)):
        assert {p.dtype for p in model.parameters()} == {
            torch.bfloat16 if BF16[0] in over else torch.float32}
    opt = port_optimizer.make_optimizer(s_port.parameters(), 1e-3, 1e-4)
    pspec = pd.DistillSpec(teacher=t_port, kd=partial(
        pd.grid_kd_loss, class_weights=make_class_weights(14, 0.05)), alpha=0.5,
        temperature=2.0)
    step = make_port_train_step(s_port, PortLossFn(pc.LossConfig(), pc.GridConfig()), opt, 14,
                                distill=pspec)
    _, got = step(create_port_state(s_port, opt), *_port_batch(*BATCHES[0]), (0, 1))
    for k in ("loss", "hard", "kd"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-3, err_msg=k)


# --- import-torch and predict against JAX ------------------------------------------------


def test_import_torch_under_a_bf16_config_serves_jax_s_restored_weights(tmp_path):
    """The JAX converter writes float32 leaves whatever param_dtype is, and
    its checkpoint restore under a bf16 config rounds them to bf16 to
    nearest even (the template's dtype). The port's import rounds the same
    way at import and stores bf16: the weights served are equal bit for
    bit."""
    from seld_tpu.tools.torch_import import convert_torch_state_dict as jax_convert
    from seld_tpu_torch.tools.torch_import import import_state_dict
    from tests.test_torch_reference_import import BACKBONES, reference_of

    overrides, kwargs = BACKBONES["conformer"]
    _, ref, _ = reference_of(overrides)
    pcfg = pc.parse_overrides(pc.Config(), overrides + BF16)
    got = import_state_dict(ref, pcfg.model, pcfg.grid.num_classes)
    jax_vars = jax_convert(ref, "conformer", **kwargs)
    assert all(np.asarray(x).dtype == np.float32 for x in jax.tree.leaves(jax_vars))
    want = state_dict_from_jax({"params": bf16_tree(jax_vars["params"]),
                                "batch_stats": jax_vars["batch_stats"]}, pcfg.model)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    torch.save(ref, tmp_path / "ref.pth")
    assert port_main(["import-torch", "--torch-checkpoint", str(tmp_path / "ref.pth"),
                      "--device", "cpu", f"data.base_path={tmp_path}", *overrides, *BF16]) == 0
    blob = torch.load(next((tmp_path / "checkpoints" / "best").iterdir()), weights_only=True)
    for k, v in want.items():
        assert torch.equal(blob["state_dict"][k], v), k


def test_predict_from_a_bf16_checkpoint_matches_jax(tmp_path):
    """The same random weights in a JAX checkpoint tree and a port file
    under a bf16-parameter config (the JAX restore rounds its float32 leaves
    to bf16, the port's converter too): the two predictors' class grids
    agree outside the top-2 margin band of tests/test_torch_predict.py."""
    from seld_tpu.infer import SELDPredictor as JaxPredictor
    from seld_tpu_torch.data.corpus import compute_mel_features
    from seld_tpu_torch.infer import SELDPredictor
    from tests.test_torch_predict import _assert_same_decisions, _top2_margin
    from tests.test_torch_tta import jax_and_port_checkpoints

    overrides = TINY["conformer"] + BF16 + ["model.compute_dtype=float32"]
    jax_ckpt, port_ckpt = jax_and_port_checkpoints(tmp_path, overrides, batch=2)
    jax_pred = JaxPredictor(jax_ckpt, batch_windows=2)
    port_pred = SELDPredictor(port_ckpt, batch_windows=2, device="cpu")
    assert {p.dtype for p in port_pred.model.parameters()} == {torch.bfloat16}
    wave = (np.random.default_rng(8).standard_normal((4, 24_000)) * 0.2).astype(np.float32)
    want = jax_pred.predict_waveform(wave).classes
    got = port_pred.predict_waveform(wave).classes
    mel = compute_mel_features(wave, port_pred.cfg.features, device="cpu")
    t, win = mel.shape[0], port_pred.win
    n = -(-t // win)
    mel = torch.cat([mel, mel.new_zeros((n * win - t, *mel.shape[1:]))])
    logits = port_pred._raw_apply(mel.reshape(n, win, *mel.shape[1:]))
    _assert_same_decisions(want, got, _top2_margin(logits.reshape(n * win,
                                                                  *logits.shape[2:])[:t]))


# --- a tiny bf16 CRNN through the command line -------------------------------------------

CRNN_RUN = ["model.model_type=crnn", "model.crnn_cnn_channels=8,16",
            "model.crnn_rnn_hidden=16", "model.crnn_rnn_layers=1", *BF16,
            "window.window_seconds=1.0", "window.hop_seconds=4.0", "train.batch_size=8",
            "train.num_epochs=2", "train.save_every_n_epochs=1", "train.ema_decay=0.9"]


def test_cli_chain_of_a_bf16_crnn(tmp_path):
    """cli train (bf16 compute, EMA) -> eval -> predict -> export, the
    artifact's predict equal to the checkpoint's, and the daemon's stream
    equal to the offline predict; the checkpoints hold bf16 weights and
    moments, the EMA shadow in the best file is bf16."""
    from seld_tpu_torch.data.audio import write_wav
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.serve import SELDServer, stream_client

    base = ["--device", "cpu", f"data.base_path={tmp_path}"]  # flags, then overrides
    assert port_main(["train", "--synthetic", *base, *CRNN_RUN]) == 0
    rolling = torch.load(tmp_path / "checkpoints" / "rolling" / "epoch_0002.pt",
                         weights_only=True)
    assert rolling["state_dict"]["rnn.layers.0.weight_ih_l0"].dtype == torch.bfloat16
    assert rolling["state_dict"]["encoder.blocks.0.bn.running_var"].dtype == torch.float32
    assert {s["mu"].dtype for s in rolling["optimizer"]["state"].values()} == {torch.bfloat16}
    best = next((tmp_path / "checkpoints" / "best").iterdir())
    assert torch.load(best, weights_only=True)["state_dict"]["head.fc.weight"].dtype == \
        torch.bfloat16
    assert port_main(["eval", "--synthetic", "--num-visualizations", "0", *base,
                      *CRNN_RUN]) == 0
    wave = (np.random.default_rng(4).standard_normal((4, 2 * 24_000)) * 0.1).astype(np.float32)
    write_wav(tmp_path / "clip.wav", wave, 24_000)
    run, cpu = f"data.base_path={tmp_path}", ["--device", "cpu"]  # the override first
    assert port_main(["predict", run, *cpu, "--out", str(tmp_path / "ckpt_out"), "--wavs",
                      str(tmp_path / "clip.wav")]) == 0
    assert port_main(["export", run, *cpu, "--out", str(tmp_path / "a.pt2"),
                      "--batch-windows", "2"]) == 0
    assert port_main(["predict", run, *cpu, "--artifact", str(tmp_path / "a.pt2"), "--out",
                      str(tmp_path / "art_out"), "--wavs", str(tmp_path / "clip.wav")]) == 0
    csv = lambda d: (tmp_path / d / "predictions" / "clip.csv").read_text()  # noqa: E731
    assert csv("art_out") == csv("ckpt_out")
    predictor = SELDPredictor(best, batch_windows=1, device="cpu")
    server = SELDServer(predictor, port=0)
    thread = server.serve_background()
    try:
        chunks = [wave[:, i:i + 6000] for i in range(0, wave.shape[1], 6000)]
        classes, _ = stream_client("127.0.0.1", server.port, chunks, timeout=60)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    np.testing.assert_array_equal(classes, predictor.predict_waveform(wave).classes)


def test_cli_verify_takes_the_override_as_jax_does(capsys):
    """`verify` builds every backbone at its default widths in float32 and
    ignores model.* overrides, in both packages (seld_tpu/cli.py's
    cmd_verify): the bf16 override parses and every backbone is OK."""
    assert port_main(["verify", "--frames", "4", "--device", "cpu", *BF16]) == 0
    assert capsys.readouterr().out.count(" OK ") == 6
