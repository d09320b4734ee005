"""The port's other grid backbones (CRNN, Conformer, CSPDarkNet "cnn")
against seld_tpu's, on the CPU at tiny widths: eval-mode and train-mode
logits, the updated BatchNorm statistics and every parameter's gradient,
with the same numpy inputs and random JAX variables carried across by
seld_tpu_torch.convert.state_dict_from_jax; the parameter counts of all
four grid backbones at their default widths; the pooling and resize
matrices against the JAX package's; the config's tuple fields; and `cli
train` -> `eval` -> `predict` of a tiny CRNN on the CPU."""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from seld_tpu.config import Config, config_to_dict, parse_overrides
from seld_tpu.models import build_model
from seld_tpu.ops.pooling import adaptive_avg_pool_2d as jax_adaptive_pool
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.models import layers as port_layers
from seld_tpu_torch.ops.pooling import adaptive_avg_pool_2d, bilinear_resize
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

TINY = {
    "crnn": ["model.model_type=crnn", "model.crnn_cnn_channels=8,16",
             "model.crnn_rnn_hidden=16", "model.crnn_rnn_layers=2"],
    "conformer": ["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                  "model.conf_d_model=32", "model.conf_n_heads=4", "model.conf_n_layers=1"],
    "cnn": ["model.model_type=cnn"],  # CSPDarkNet at its small default widths
}
F32 = ["model.compute_dtype=float32"]
B, T = 4, 6
# eval mode: the bar of tests/test_torch_model.py (measured: 1.4e-6 / 7.7e-7)
ATOL, RTOL = 5e-4, 1e-3


def random_variables(model, x0, seed=0):
    """numpy variables of the JAX model for input x0: the tree's shapes from
    jax.eval_shape (no init compile), kernels from N(0, 1/fan_in), random
    norm scales and biases and BatchNorm statistics, so that a layout
    mistake cannot hide behind the 0/1 init."""
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


def two_pass_variance(monkeypatch):
    """flax computes a batch variance as E[x^2] - E[x]^2, which loses digits
    in float32; make it mean((x - mean)^2), the port's formula, while a
    function is traced (as tests/test_torch_train.py does)."""
    from flax.linen import normalization

    fast = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: fast(*a, **{**k, "use_fast_variance": False}))


def port_model(variables, overrides, dropout=None):
    """The port model of `overrides` holding the JAX variables; dropout
    sets every Dropout's rate (0 for train-mode parity: flax's and torch's
    masks can never be equal)."""
    cfg = pc.parse_overrides(pc.Config(), overrides)
    model = build_port_model(cfg.model, cfg.grid, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_jax(variables, cfg.model))
    if dropout is not None:
        for m in model.modules():
            if isinstance(m, port_layers.Dropout):
                m.p = dropout
    return model


@pytest.fixture(scope="module", params=sorted(TINY))
def backbone(request):
    """(name, JAX model, random numpy variables, float32 overrides)."""
    overrides = TINY[request.param] + F32
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid)
    x0 = jnp.zeros((B, T, 4, 64), jnp.float32)
    return request.param, model, random_variables(model, x0), overrides


def _input(seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, 4, 64)).astype(np.float32)


def test_eval_logits_match_jax(backbone):
    _, model, variables, overrides = backbone
    x = _input()
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = port_model(variables, overrides)(torch.from_numpy(x))
    # the JAX side's contract (tests/test_models.py:44-52), then the values
    assert got.shape == want.shape == (B, T, 14, 648) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_train_mode_logits_and_statistics_match_jax(backbone, monkeypatch):
    """One train-mode forward at dropout 0: logits to 1e-4 (measured 2e-6
    CRNN, 3e-6 Conformer, 1.3e-5 CSPDarkNet, against flax with a two-pass
    variance), and every updated BatchNorm statistic to 1e-5 (flax's
    biased variance at momentum 0.9); the statistics must move
    (tests/test_models.py:55-67)."""
    _, model, variables, overrides = backbone
    model = model.clone(dropout=0.0)
    x = _input(2)
    two_pass_variance(monkeypatch)
    want, updates = jax.jit(lambda v, x: model.apply(v, x, train=True,
                                                     mutable=["batch_stats"]))(variables, x)
    port = port_model(variables, overrides, dropout=0.0).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    cfg = pc.parse_overrides(pc.Config(), overrides).model
    want_state = state_dict_from_jax(
        jax.tree.map(np.asarray, {"params": variables["params"], **updates}), cfg)
    before = state_dict_from_jax(variables, cfg)
    stats = [k for k in want_state if "running_" in k]
    assert stats
    assert any(not torch.equal(want_state[k], before[k]) for k in stats)
    got_state = port.state_dict()
    for k in stats:
        np.testing.assert_allclose(got_state[k].numpy(), want_state[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_train_mode_gradients_match_jax(backbone, monkeypatch):
    """Every parameter's gradient, by name, of a seeded linear functional
    of the train-mode logits, to 1e-3 of its tensor's largest (measured
    2e-6 CRNN, 2.3e-5 CSPDarkNet). Gradients that are zero by construction
    (a key bias under softmax, a bias before a BatchNorm) are rounding
    noise: 1e-5 of the model's largest. The GRU's hidden r/z biases have
    no flax counterpart (flax folds them into the input biases): they are
    held out of the update, so their gradient must be exactly zero."""
    name, model, variables, overrides = backbone
    model = model.clone(dropout=0.0)
    x = _input(3)
    w = np.random.default_rng(9).standard_normal((B, T, 14, 648)).astype(np.float32)
    two_pass_variance(monkeypatch)

    def loss(params):
        out, _ = model.apply({**variables, "params": params}, x, train=True,
                             mutable=["batch_stats"])
        return jnp.mean(out * w)

    grads = jax.jit(jax.grad(loss))(variables["params"])
    cfg = pc.parse_overrides(pc.Config(), overrides).model
    want = state_dict_from_jax(jax.tree.map(np.asarray, {
        "params": grads, "batch_stats": variables["batch_stats"]}), cfg)
    port = port_model(variables, overrides, dropout=0.0).train()
    (port(torch.from_numpy(x)) * torch.from_numpy(w)).mean().backward()
    largest = max(v.abs().max().item() for k, v in want.items() if "running_" not in k)
    checked = 0
    for pname, p in port.named_parameters():
        got, ref = p.grad.numpy(), want[pname].numpy()
        if pname.endswith(("attn.w_k.bias", "conv.depthwise.bias")):
            assert np.abs(got).max() < 1e-5 * largest, pname
            continue
        if "bias_hh" in pname:  # [r|z|n]: r and z are held at zero
            h = got.shape[0] // 3
            assert not np.any(got[:2 * h]), pname
            got, ref = got[2 * h:], ref[2 * h:]
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max() + 1e-5 * largest,
                                   err_msg=pname)
        checked += 1
    assert checked >= {"crnn": 20, "conformer": 30, "cnn": 100}[name]


def test_one_adam_step_of_the_crnn_matches_optax(monkeypatch):
    """One train step of the small CRNN, the port's Adam with coupled L2
    against seld_tpu's optax chain (lr 1e-3, weight decay 1e-4), from the
    same converted weights and batch at dropout 0: every parameter after
    the step at the eval bar (ATOL / RTOL; an Adam step moves an entry by
    about lr, so a parameter whose update went twice as far, or the wrong
    way, misses it). Adam's first step is lr * sign(g + wd * p) for all but
    the smallest entries, so where that decayed gradient lies within the
    gradient bar of test_train_mode_gradients_match_jax (1e-3 of its
    tensor's largest) its sign is rounding noise (measured: 2 of 4.6 M
    entries of the head's logits kernel): there the step must only be at
    most 2 lr. The GRU's hidden r/z biases stay exactly at zero: torch's
    redundant copies of flax's input biases must not move, or the
    effective bias moves twice as far as flax's."""
    import optax

    from seld_tpu.train.optimizer import make_optimizer as jax_optimizer
    from seld_tpu_torch.train.optimizer import make_optimizer as port_optimizer

    overrides = TINY["crnn"] + F32
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid).clone(dropout=0.0)
    variables = random_variables(model, jnp.zeros((B, T, 4, 64), jnp.float32), seed=5)
    x = _input(5)
    w = np.random.default_rng(6).standard_normal((B, T, 14, 648)).astype(np.float32)
    two_pass_variance(monkeypatch)

    def loss(params):
        out, upd = model.apply({**variables, "params": params}, x, train=True,
                               mutable=["batch_stats"])
        return jnp.sum(out * w), upd

    grads, updates = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
    opt = jax_optimizer(1e-3, 1e-4)
    step, _ = opt.update(grads, opt.init(variables["params"]), variables["params"])
    new_params = optax.apply_updates(variables["params"], step)
    pcfg = pc.parse_overrides(pc.Config(), overrides).model
    want = state_dict_from_jax(jax.tree.map(np.asarray, {"params": new_params, **updates}),
                               pcfg)
    before = state_dict_from_jax(variables, pcfg)
    decayed = state_dict_from_jax(jax.tree.map(np.asarray, {
        "params": grads, "batch_stats": variables["batch_stats"]}), pcfg)

    port = port_model(variables, overrides, dropout=0.0).train()
    optimizer = port_optimizer(port.parameters(), 1e-3, 1e-4)
    (port(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    optimizer.step()
    got = port.state_dict()
    assert set(got) == set(want)
    for name, ref in want.items():
        got_np, ref_np = got[name].numpy(), ref.numpy()
        if "running_" not in name:
            g = decayed[name].numpy() + 1e-4 * before[name].numpy()
            noise = np.abs(g) <= 1e-3 * np.abs(g).max()
            assert np.all(np.abs(got_np - ref_np)[noise] <= 2e-3 + ATOL), name
            got_np, ref_np = got_np[~noise], ref_np[~noise]
        np.testing.assert_allclose(got_np, ref_np, atol=ATOL, rtol=RTOL, err_msg=name)
    for gru in port.rnn.layers:
        for bias in (gru.bias_hh_l0, gru.bias_hh_l0_reverse):
            assert not bias[:2 * pcfg.crnn_rnn_hidden].any()


def test_bf16_crnn_matches_jax():
    """The default compute dtype: flax runs the GRU's gate products in bf16
    with a float32 carry; the port runs the recurrence in float32 between
    a bf16 encoder and a bf16 head (seld_tpu_torch/models/crnn.py). Held to
    0.05 on logits of scale 3 (measured 0.023: bf16 roundings of the
    encoder, the gates and the head)."""
    overrides = TINY["crnn"]
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid)
    variables = random_variables(model, jnp.zeros((B, T, 4, 64), jnp.float32))
    x = _input(4)
    want = np.asarray(model.apply(variables, x, train=False))
    port = port_model(variables, overrides)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert port.rnn.layers[0].weight_ih_l0.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=0)


@pytest.mark.parametrize("model_type", ["crnn", "conformer", "resnet_conformer", "cnn"])
def test_parameter_counts_match_jax_at_default_widths(model_type):
    """The default widths of each grid backbone: the JAX count from
    jax.eval_shape (no init), the port's from the model built on the meta
    device. torch's GRU carries hidden biases on r and z that flax folds
    into the input biases: 2 x hidden more per direction and layer."""
    cfg = parse_overrides(Config(), [f"model.model_type={model_type}"])
    model = build_model(cfg.model, cfg.grid)
    x0 = jnp.zeros((1, 4, 4, 64), jnp.float32)
    shapes = jax.eval_shape(lambda r: model.init({"params": r, "dropout": r}, x0,
                                                 train=False), jax.random.PRNGKey(0))
    want = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))
    pcfg = pc.parse_overrides(pc.Config(), [f"model.model_type={model_type}"])
    port = build_port_model(pcfg.model, pcfg.grid, device="meta", seed=None)
    got = sum(p.numel() for p in port.parameters())
    extra = (2 * 2 * pcfg.model.crnn_rnn_layers * pcfg.model.crnn_rnn_hidden
             if model_type == "crnn" else 0)
    assert got == want + extra, (model_type, got, want)


def test_converter_raises_on_missing_and_unknown_keys():
    overrides = TINY["crnn"] + F32
    cfg = parse_overrides(Config(), overrides)
    variables = random_variables(build_model(cfg.model, cfg.grid),
                                 jnp.zeros((1, 4, 4, 64), jnp.float32))
    pcfg = pc.parse_overrides(pc.Config(), overrides).model
    broken = jax.tree.map(lambda x: x, variables)
    del broken["params"]["BiGRU_0"]["GRUCell_3"]["hn"]["bias"]
    with pytest.raises(KeyError, match="GRUCell_3/hn/bias"):
        state_dict_from_jax(broken, pcfg)
    extra = jax.tree.map(lambda x: x, variables)
    extra["params"]["BiGRU_0"]["GRUCell_4"] = extra["params"]["BiGRU_0"]["GRUCell_2"]
    with pytest.raises(KeyError, match="does not know"):
        state_dict_from_jax(extra, pcfg)


# --- pooling and resize ---------------------------------------------------


@pytest.mark.parametrize("in_hw,out_hw", [((16, 1), (18, 36)), ((7, 5), (3, 2)),
                                          ((4, 4), (4, 4))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adaptive_pool_matches_jax(in_hw, out_hw, dtype):
    """The two products against the JAX package's (NHWC there) in float32
    and bf16 (the matrices cast to the input's dtype on both sides), and
    against F.adaptive_avg_pool2d in float32."""
    x = np.random.default_rng(5).standard_normal((3, 2, *in_hw)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_adaptive_pool(jnp.asarray(x.transpose(0, 2, 3, 1), jdt), out_hw)
                      .astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = adaptive_avg_pool_2d(torch.from_numpy(x).to(getattr(torch, dtype)), out_hw)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7  # one bf16 rounding of values ~2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(
            got.numpy(), F.adaptive_avg_pool2d(torch.from_numpy(x), out_hw).numpy(),
            atol=1e-6)


@pytest.mark.parametrize("in_hw,out_hw", [((8, 1), (16, 1)), ((4, 1), (16, 1)),
                                          ((5, 3), (16, 7)), ((16, 9), (5, 4))])
def test_bilinear_resize_matches_jax_image_resize(in_hw, out_hw):
    """jax.image.resize(method="bilinear") as the CSPDarkNet calls it
    (seld_tpu/models/cspdarknet.py:207): P4 (8, 1) and P5 (4, 1) to P3's
    (16, 1) are the model's shapes; a 2-D upsample and a downsample (where
    jax's antialiasing widens the kernel) hold the matrices in general."""
    x = np.random.default_rng(6).standard_normal((3, 2, *in_hw)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, 2, *out_hw), method="bilinear"))
    got = bilinear_resize(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# --- config and the command line -----------------------------------------


def test_tuple_fields_parse_and_round_trip():
    cfg = pc.parse_overrides(pc.Config(), ["model.crnn_cnn_channels=8,16",
                                           "model.remat=all", "model.csp_use_small=false"])
    assert cfg.model.crnn_cnn_channels == (8, 16)
    assert cfg.model.remat == "all" and cfg.model.csp_use_small is False
    again = pc.config_from_dict(json.loads(json.dumps(pc.config_to_dict(cfg))))
    assert again == cfg  # a JSON list comes back a tuple
    jax_cfg = parse_overrides(Config(), ["model.crnn_cnn_channels=8,16"])
    assert pc.config_from_dict(config_to_dict(jax_cfg)).model.crnn_cnn_channels == (8, 16)


CLI_TINY = [*TINY["crnn"], "model.crnn_rnn_layers=1", *F32, "window.window_seconds=1.0",
            "window.hop_seconds=4.0", "train.batch_size=8", "train.num_epochs=1",
            "train.save_every_n_epochs=1"]


def test_cli_train_eval_predict_tiny_crnn(tmp_path, capsys):
    """`cli train` -> `eval` -> `predict` of a tiny CRNN on the CPU: the
    checkpoint stores the CRNN's fields, eval and the predictor rebuild it
    from there. The test removes what it wrote."""
    from seld_tpu_torch.data.synthetic import synthetic_raw_files
    from seld_tpu_torch.train.checkpoint import load_checkpoint

    try:
        overrides = [f"data.base_path={tmp_path}", *CLI_TINY]
        assert port_main(["train", "--synthetic", "--device", "cpu", *overrides]) == 0
        (best,) = (tmp_path / "checkpoints" / "best").glob("epoch_*.pt")
        cfg, _, _ = load_checkpoint(best)
        assert cfg.model.model_type == "crnn" and cfg.model.crnn_cnn_channels == (8, 16)
        capsys.readouterr()
        assert port_main(["eval", "--synthetic", "--device", "cpu", "--num-visualizations",
                          "0", *overrides]) == 0
        report = json.loads(capsys.readouterr().out)
        assert np.isfinite(report["test_loss"]) and "SELD_error" in report["dcase2022"]
        pcfg = pc.parse_overrides(pc.Config(), overrides)
        wavs, _ = synthetic_raw_files(tmp_path / "wavs", pcfg, n_files=1, seconds=2.0)
        assert port_main(["predict", "--checkpoint", str(best), "--wavs", wavs[0],
                          "--out", str(tmp_path / "out"), "--device", "cpu"]) == 0
        (csv,) = (tmp_path / "out" / "predictions").glob("*.csv")
        assert csv.stem == Path(wavs[0]).stem
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
