"""The port's training path against seld_tpu's, on the CPU: train-mode
layers, the optimizer, the train step (three steps, with accumulation and
a padded tail batch), and the trainer with its artifacts, resume,
schedules and refusals. Inputs are seeded numpy arrays handed to both
packages; weights cross through seld_tpu_torch.convert.state_dict_from_jax.
Flax's and torch's dropout draws can never be equal, so parity runs at
resnet_dropout=0 and dropout has its own tests."""

import dataclasses
import json
import shutil

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import GridConfig, LossConfig, ModelConfig
from seld_tpu.losses import SELDLossFn
from seld_tpu.models import build_model, init_variables
from seld_tpu.train.optimizer import make_optimizer, set_learning_rate
from seld_tpu.train.state import TrainState
from seld_tpu.train.steps import make_eval_step, make_train_step
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.data.synthetic import synthetic_corpus
from seld_tpu_torch.infer import SELDPredictor
from seld_tpu_torch.losses import SELDLossFn as PortLossFn
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.models import layers as port_layers
from seld_tpu_torch.train import optimizer as port_optimizer
from seld_tpu_torch.train import trainer as port_trainer
from seld_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint_config
from seld_tpu_torch.train.state import create_train_state as create_port_state
from seld_tpu_torch.train.steps import dropout_seed
from seld_tpu_torch.train.steps import make_eval_step as make_port_eval_step
from seld_tpu_torch.train.steps import make_train_step as make_port_train_step
from seld_tpu_torch.train.trainer import train_model
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import port_fails

SMALL = dict(resnet_conf_d_model=32, resnet_conf_n_heads=2, resnet_conf_n_layers=1,
             compute_dtype="float32", resnet_dropout=0.0)
B, T = 4, 6


# --- dropout and train-mode BatchNorm -------------------------------------


def _seeded_dropout(p, seed):
    drop = port_layers.Dropout(p)
    drop.generator = torch.Generator().manual_seed(seed)
    return drop


def test_dropout_rate_and_scaling():
    x = torch.ones((200, 500))
    y = _seeded_dropout(0.3, 0)(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01  # 1e5 draws: sigma 0.0015
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert abs(y.mean().item() - 1.0) < 0.02  # inverted dropout keeps the mean


def test_dropout_same_seed_same_mask():
    x = torch.randn((50, 40), generator=torch.Generator().manual_seed(1))
    a, b, c = (_seeded_dropout(0.3, s)(x) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_is_identity_in_eval_and_at_rate_zero():
    x = torch.randn((8, 8), generator=torch.Generator().manual_seed(2))
    assert port_layers.Dropout(0.3).eval()(x) is x
    assert port_layers.Dropout(0.0)(x) is x  # train mode, no generator needed


def test_dropout_needs_its_generator_and_a_valid_rate():
    with pytest.raises(RuntimeError, match="seed_dropout"):
        port_layers.Dropout(0.3)(torch.ones(4))
    with pytest.raises(ValueError, match="rate"):
        port_layers.Dropout(1.0)


def test_model_dropout_follows_its_seed_and_mode():
    cfg = pc.ModelConfig(**{**SMALL, "resnet_dropout": 0.3})
    model = build_port_model(cfg, device="cpu", seed=0)
    x = torch.randn((2, T, 4, 64), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        quiet = model(x)
        assert torch.equal(model(x), quiet)  # eval mode: no dropout, running statistics
        outs = []
        for seed in (11, 11, 12):
            fresh = build_port_model(cfg, device="cpu", seed=0).train()
            fresh.seed_dropout(seed)
            outs.append(fresh(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert dropout_seed((0, 1), 7) == dropout_seed((0, 1), 7) != dropout_seed((0, 2), 7)


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics in the output, and flax's running update: the
    biased batch variance at momentum 0.9 (torch's own update would store
    the unbiased one: a factor n / (n - 1) = 1.09 at n = 12)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 6, 5)).astype(np.float32) * 2 + 1  # (B, T, F, C)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 0.1, 5).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 5).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, updates = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}, x[:, :, :1], mutable=["batch_stats"])
    port = port_layers.BatchNorm(5).train()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in dict(
        weight=scale, bias=bias, running_mean=mean0, running_var=var0).items()})
    got = port(torch.from_numpy(x[:, :, :1]).permute(0, 3, 1, 2))  # NCHW
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(updates["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(updates["batch_stats"]["var"]), rtol=1e-5)


# --- the small flagship in train mode, and the steps ----------------------


def _randomize(variables, seed=0):
    """Random norm scales, biases and BatchNorm statistics, so that a
    layout mistake cannot hide behind the 0/1 init."""
    rng = np.random.default_rng(seed)

    def visit(path, x):
        keys = [getattr(p, "key", str(p)) for p in path]
        if keys[0] == "batch_stats":
            if keys[-1] == "mean":
                return rng.normal(0, 0.05, x.shape).astype(np.float32)
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if keys[-1] == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if keys[-1] == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(visit, variables)


def _batch(seed, n_valid=B):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, T, 4, 64)).astype(np.float32)
    mask = np.where(rng.random((B, T, 648)) < 0.9, 0,
                    rng.integers(1, 2 ** 13, (B, T, 648))).astype(np.uint16)
    em = (np.arange(B) < n_valid).astype(np.float32)
    return mel, mask, em


def _port_batch(mel, mask, em):
    return torch.from_numpy(mel), torch.from_numpy(mask.view(np.int16)), torch.from_numpy(em)


@pytest.fixture(scope="module")
def small():
    """(JAX model, randomized numpy variables, port model config)."""
    model = build_model(ModelConfig(**SMALL), GridConfig())
    variables = _randomize(init_variables(
        model, jax.random.PRNGKey(0), jnp.zeros((B, T, 4, 64), jnp.float32)))
    return model, variables, pc.ModelConfig(**SMALL)


def _port_model(variables, port_cfg):
    port = build_port_model(port_cfg, device="cpu", seed=None)
    port.load_state_dict(state_dict_from_jax(variables, port_cfg))
    return port


def _two_pass_variance(monkeypatch):
    """Make flax compute batch variances as mean((x - mean)^2) instead of
    its default E[x^2] - E[x]^2 while a function is traced. The default
    loses digits in float32 where a channel's mean^2 exceeds its variance,
    and 54 stacked batch normalisations amplify that."""
    from flax.linen import normalization

    fast = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: fast(*a, **{**k, "use_fast_variance": False}))


def _grads_as_state_dict(grads, variables, port_cfg):
    """JAX parameter gradients under the port's parameter names (the
    statistics ride along to satisfy the converter)."""
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return state_dict_from_jax(
        {"params": to_np(grads), "batch_stats": to_np(variables["batch_stats"])}, port_cfg)


def test_train_mode_forward_loss_and_stats_match_jax(small, monkeypatch):
    """Logits, loss and the updated BatchNorm statistics of one train-mode
    forward. The logits are held to 1e-3 against flax with a two-pass
    variance and to 3e-3 against the JAX package as it is, whose variance
    formula makes it the noisier of the two (the port sits 3e-4 from a
    float64 run of itself); eval mode holds 5e-4 (tests/test_torch_model.py)."""
    model, variables, port_cfg = small
    mel, mask, em = _batch(1)
    loss_fn = SELDLossFn(LossConfig(), GridConfig())

    def jax_forward(variables):
        out, updates = model.apply(variables, mel, train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
        total = loss_fn.from_bitmask(out, jnp.asarray(mask), jnp.asarray(em)).total
        return out, total, updates["batch_stats"]

    want_out, want_loss, want_stats = jax.jit(jax_forward)(variables)
    _two_pass_variance(monkeypatch)
    two_pass_out = jax.jit(lambda v: jax_forward(v)[0])(variables)

    port = _port_model(variables, port_cfg).train()
    p_mel, p_mask, p_em = _port_batch(mel, mask, em)
    with torch.no_grad():
        out = port(p_mel)
        total = PortLossFn(pc.LossConfig(), pc.GridConfig()).from_bitmask(out, p_mask, p_em).total
    np.testing.assert_allclose(out.numpy(), np.asarray(two_pass_out), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=3e-3, rtol=1e-3)
    np.testing.assert_allclose(total.item(), float(want_loss), rtol=1e-4)
    want_state = state_dict_from_jax(
        jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": want_stats}),
        port_cfg)
    got_state = port.state_dict()
    stats = [k for k in want_state if "running_" in k]
    assert len(stats) == 2 * 54  # 53 encoder norms and the conformer block's
    for k in stats:  # near-zero means carry float32 noise of a few 1e-6
        np.testing.assert_allclose(got_state[k].numpy(), want_state[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_train_mode_gradients_match_jax(small, monkeypatch):
    """Parameter gradients of a seeded linear functional of the train-mode
    logits, by name, against flax with a two-pass variance.

    Float32 gradients through 16 train-mode bottlenecks are noise-limited
    at this size: against a float64 run of the port, the port, flax
    two-pass and flax as-is each sit about 2 % of a tensor's largest
    gradient off in the encoder (4 % for flax as-is). So the tensors after
    the encoder, where the conditioning is good, are held to 2 % of their
    largest gradient each (measured 5e-3), and the encoder as a whole to a
    relative L2 error of 10 %; a layout, sign or scale mistake gives O(1).
    The blocks on their own are held to 1e-3 in the tests below."""
    model, variables, port_cfg = small
    mel, _, _ = _batch(1)
    w = np.random.default_rng(9).standard_normal((B, T, 14, 648)).astype(np.float32)

    def jax_loss(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, mel,
                             train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(out * w)

    _two_pass_variance(monkeypatch)
    want = _grads_as_state_dict(jax.jit(jax.grad(jax_loss))(variables["params"]),
                                variables, port_cfg)
    port = _port_model(variables, port_cfg).train()
    (port(torch.from_numpy(mel)) * torch.from_numpy(w)).mean().backward()

    largest = max(v.abs().max().item() for k, v in want.items() if "running_" not in k)
    enc_err = enc_norm = 0.0
    for name, p in port.named_parameters():
        ref = want[name].numpy()
        if name.endswith(("attn.w_k.bias", "conv.depthwise.bias")):
            # zero by construction (softmax ignores a key bias; BatchNorm a bias before it)
            assert np.abs(p.grad.numpy()).max() < 1e-5 * largest, name
        elif name.startswith("encoder."):
            enc_err += float(np.square(p.grad.numpy() - ref).sum())
            enc_norm += float(np.square(ref).sum())
        else:
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=2e-2 * np.abs(ref).max(), err_msg=name)
    assert (enc_err / enc_norm) ** 0.5 < 0.1


def _block_layers(port_cfg, jax_prefix, port_prefix):
    """The converter's (JAX path, port name, kind) rows of one block, with
    the block's own prefixes cut off."""
    from seld_tpu_torch.convert import _resnet_conformer_layers

    return [(j[len(jax_prefix):], p[len(port_prefix):], kind)
            for j, p, kind in _resnet_conformer_layers(port_cfg) if j.startswith(jax_prefix)]


def _convert_block(tree, layers):
    from seld_tpu_torch.convert import _convert, _flatten

    leaves = _flatten(tree)
    out = {}
    for jax_path, port_name, kind in layers:
        for leaf, v in _convert(lambda col, lf: leaves[f"{col}/{jax_path}/{lf}"], kind).items():
            out[f"{port_name}.{leaf}"] = np.array(v, np.float32)
    return out


def _check_block_in_train_mode(monkeypatch, jax_block, jax_vars, port_block, layers, x,
                               to_port, from_port):
    """One block on its own, train mode, under a seeded linear functional
    of its output: output to 1e-4, updated statistics to 1e-4, every
    gradient to 1e-3 of the tensor's largest (flax with a two-pass
    variance, so that both sides compute the same formula)."""
    _two_pass_variance(monkeypatch)
    port_block.load_state_dict(
        {k: torch.from_numpy(v) for k, v in _convert_block(jax_vars, layers).items()})

    def jax_out(params):
        out, updates = jax_block.apply({**jax_vars, "params": params}, x, True,
                                       mutable=["batch_stats"])
        return out, updates["batch_stats"]

    want_out, want_stats = jax_out(jax_vars["params"])
    w = np.random.default_rng(21).standard_normal(want_out.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.mean(jax_out(p)[0] * w))(jax_vars["params"])
    want = _convert_block({"params": grads, "batch_stats": want_stats}, layers)

    out = from_port(port_block.train()(to_port(torch.from_numpy(x))))
    (out * torch.from_numpy(w)).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-4, rtol=1e-4)
    names = [name for name, _ in port_block.named_parameters()]
    largest = max(np.abs(want[name]).max() for name in names)
    for name, p in port_block.named_parameters():
        # a gradient that is zero by construction (a key bias, a bias before
        # a BatchNorm) is rounding noise on both sides: 1e-5 of the largest
        np.testing.assert_allclose(
            p.grad.numpy(), want[name], rtol=1e-3,
            atol=1e-3 * np.abs(want[name]).max() + 1e-5 * largest, err_msg=name)
    buffers = dict(port_block.named_buffers())
    assert buffers
    for name, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), want[name], rtol=1e-4, atol=1e-6, err_msg=name)


def test_bottleneck_train_mode_matches_jax(small, monkeypatch):
    """A projecting bottleneck: four batch normalisations, a strided 3x3."""
    from seld_tpu.models.resnet_conformer import BottleneckBlock
    from seld_tpu_torch.models.resnet_conformer import BottleneckBlock as PortBottleneck

    _, variables, port_cfg = small
    sub = {col: variables[col]["ResNet50Encoder_0"]["stage2_block0"] for col in variables}
    x = np.random.default_rng(20).standard_normal((B, T, 8, 256)).astype(np.float32)  # NHWC
    _check_block_in_train_mode(
        monkeypatch, BottleneckBlock(planes=128, stride=(1, 2)), sub,
        PortBottleneck(256, 128, stride=(1, 2)),
        _block_layers(port_cfg, "ResNet50Encoder_0/stage2_block0/", "encoder.stage2_block0."),
        x, lambda t: t.permute(0, 3, 1, 2), lambda t: t.permute(0, 2, 3, 1))


def test_conformer_block_train_mode_matches_jax(small, monkeypatch):
    from seld_tpu.models.layers import ConformerBlock

    _, variables, port_cfg = small
    sub = {col: variables[col]["block_0"] for col in variables}
    x = np.random.default_rng(22).standard_normal((B, T, 32)).astype(np.float32)
    _check_block_in_train_mode(
        monkeypatch, ConformerBlock(d_model=32, n_heads=2, d_ff=128, dropout=0.0), sub,
        port_layers.ConformerBlock(32, 2, 128, dropout=0.0),
        _block_layers(port_cfg, "block_0/", "blocks.0."), x, lambda t: t, lambda t: t)


def test_optimizer_matches_optax_over_three_steps():
    rng = np.random.default_rng(5)
    shapes = {"w": (7, 5), "b": (5,), "scale": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lrs = [1e-2, 1e-2, 5e-3]  # the plateau schedule rewrites it between steps

    tx = make_optimizer(lrs[0], weight_decay=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    pp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = port_optimizer.make_optimizer(pp.values(), lrs[0], weight_decay=1e-2)
    for lr, g in zip(lrs, grads):
        opt_state = set_learning_rate(opt_state, lr)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        port_optimizer.set_learning_rate(opt, lr)
        assert port_optimizer.current_learning_rate(opt) == lr
        for k, p in pp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        # every parameter decays, biases and scales too; values near zero
        # carry the float32 rounding of O(1e-2) updates
        for k in params:
            np.testing.assert_allclose(pp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_three_train_steps_match_jax(small, accum_steps):
    """Loss per step to rtol 1e-3 (three updates compound the float32
    differences) and the eval loss after them. Adam's first steps move
    every weight by about the learning rate in its gradient's direction,
    noise-sized gradients included, so the weights themselves are not
    compared. The last batch is a padded tail: with accum_steps=2 its second
    microbatch is all padding and must add nothing."""
    model, variables, port_cfg = small
    batches = [_batch(10), _batch(11), _batch(12, n_valid=2)]
    loss_fn = SELDLossFn(LossConfig(), GridConfig())
    tx = make_optimizer(1e-3, 1e-4)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    jstep = make_train_step(model, loss_fn, tx, 14, donate=False, accum_steps=accum_steps)
    want = []
    for mel, mask, em in batches:
        state, metrics = jstep(state, mel, mask, em, jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))
    want_eval = float(make_eval_step(model, loss_fn, 14)(state, *batches[0])["loss"])

    port = _port_model(variables, port_cfg)
    opt = port_optimizer.make_optimizer(port.parameters(), 1e-3, 1e-4)
    ploss = PortLossFn(pc.LossConfig(), pc.GridConfig())
    pstep = make_port_train_step(port, ploss, opt, 14, accum_steps=accum_steps)
    pstate = create_port_state(port, opt)
    got = []
    for batch in batches:
        _, metrics = pstep(pstate, *_port_batch(*batch), (0, 1))
        assert set(metrics) == {"loss", "class_mse"} and not metrics["loss"].requires_grad
        got.append(metrics["loss"].item())
    assert pstate.step == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    got_eval = make_port_eval_step(port, ploss, 14)(*_port_batch(*batches[0]))["loss"].item()
    assert not port.training
    np.testing.assert_allclose(got_eval, want_eval, rtol=2e-3)


def test_train_step_refuses_what_it_cannot_split(small):
    _, variables, port_cfg = small
    port = _port_model(variables, port_cfg)
    opt = port_optimizer.make_optimizer(port.parameters(), 1e-3)
    ploss = PortLossFn(pc.LossConfig(), pc.GridConfig())
    step = make_port_train_step(port, ploss, opt, 14, accum_steps=3)
    with pytest.raises(ValueError, match="divisible"):
        step(create_port_state(port, opt), *_port_batch(*_batch(13)), (0, 1))
    with pytest.raises(ValueError, match="num_classes"):
        make_port_train_step(port, ploss, opt, 13)


# --- the trainer ----------------------------------------------------------

# the smallest flagship the config allows still holds the ResNet50 (23.5 M
# parameters): a checkpoint with its Adam moments is 0.3 GB, so every test
# below removes what it wrote
TINY = ["model.resnet_conf_d_model=16", "model.resnet_conf_n_heads=2",
        "model.resnet_conf_n_layers=1", "model.compute_dtype=float32",
        "grid.cell_degrees=30", "window.window_seconds=0.2", "window.hop_seconds=0.2",
        "train.batch_size=4", "train.num_epochs=2", "train.save_every_n_epochs=1"]
N_CELLS = 6 * 12


def _tiny_cfg(base, *extra):
    return pc.parse_overrides(pc.Config(), [*TINY, f"data.base_path={base}", *extra])


@pytest.fixture(autouse=True)
def remove_what_the_test_wrote(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def corpora():
    cfg = _tiny_cfg(".")
    return (synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=0, device="cpu"),
            synthetic_corpus(cfg, n_files=1, seconds=1.0, seed=1, train=False, device="cpu"))


@pytest.fixture(scope="module")
def trained(tmp_path_factory, corpora):
    """A two-epoch run of the tiny model: (cfg, workdir, state, history)."""
    base = tmp_path_factory.mktemp("port_train")
    cfg = _tiny_cfg(base)
    state, history = train_model(cfg, *corpora, device="cpu")
    yield cfg, base / "checkpoints", state, history
    shutil.rmtree(base, ignore_errors=True)


def _records(workdir):
    return [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]


def test_train_model_writes_its_artifacts(trained):
    cfg, work, state, history = trained
    assert [r["epoch"] for r in _records(work)] == [1, 2]
    assert all(np.isfinite(r[s]["loss"]) and "class_mse" in r[s]
               for r in _records(work) for s in ("train", "test"))
    assert sorted(f.name for f in (work / "rolling").iterdir()) == ["epoch_0001.pt",
                                                                   "epoch_0002.pt"]
    assert len(list((work / "best").iterdir())) == 1
    saved = json.loads((work / "training_history.json").read_text())
    assert saved == history and history["total_epochs"] == 2
    assert len(history["train_losses"]) == len(history["lr"]) == 2
    assert state.step == 2 * 3  # 10 windows at batch 4: 3 steps an epoch, one padded
    assert load_checkpoint_config(work) == cfg


def test_best_checkpoint_serves_through_the_predictor(trained):
    cfg, work, state, _ = trained
    best = CheckpointManager(work, cfg).best_path()
    pred = SELDPredictor(best, batch_windows=2, device="cpu")
    assert pred.cfg == cfg and pred.epoch == CheckpointManager(work, cfg).best_meta()["epoch"]
    for k, v in pred.model.state_dict().items():  # train_model returns the best weights
        assert torch.equal(v, state.model.state_dict()[k]), k
    wave = 0.1 * np.random.default_rng(0).standard_normal((4, 12_000)).astype(np.float32)
    assert pred.predict_waveform(wave).classes.shape == (26, N_CELLS)


def test_resume_continues_epochs_and_learning_rate(trained, corpora, tmp_path):
    cfg, trained_work, _, _ = trained
    work = tmp_path / "checkpoints"
    for kept in ("rolling/epoch_0002.pt", "metrics.jsonl",
                 next((trained_work / "best").iterdir()).relative_to(trained_work)):
        (work / kept).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(trained_work / kept, work / kept)
    # a reduced LR in the newest rolling checkpoint must survive the resume
    newest = work / "rolling" / "epoch_0002.pt"
    blob = torch.load(newest, weights_only=True)
    blob["optimizer"]["param_groups"][0]["lr"] = 2.5e-4
    torch.save(blob, newest)
    cfg3 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_epochs=3))
    state, history = train_model(cfg3, *corpora, workdir=work, resume=True, device="cpu")
    records = _records(work)
    assert [r["epoch"] for r in records] == [1, 2, 3]
    assert records[-1]["lr"] == 2.5e-4 and history["lr"] == [2.5e-4]
    assert state.step in (6, 9)  # the reloaded best checkpoint's: epoch 2's or epoch 3's
    assert history["total_epochs"] == 3
    assert (work / "rolling" / "epoch_0003.pt").exists()
    # a fresh run into the same directory starts from a clean tree
    stale = work / "best" / "epoch_0099.pt"
    stale.write_bytes(b"stale")
    cfg1 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_epochs=1))
    train_model(cfg1, *corpora, workdir=work, device="cpu")
    assert [r["epoch"] for r in _records(work)] == [1] and not stale.exists()
    assert [f.name for f in (work / "rolling").iterdir()] == ["epoch_0001.pt"]


def test_rolling_checkpoints_keep_the_newest(trained, corpora, tmp_path):
    cfg, _, state, _ = trained
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             keep_last_n_checkpoints=2))
    mgr = CheckpointManager(tmp_path, cfg)
    for epoch in (1, 2, 3):
        mgr.save_rolling(epoch, state, 0.5, 0.25)
        mgr.save_best(epoch, state, 0.5, 0.25)
    mgr.wait()  # the saves write in the background
    assert sorted(f.name for f in mgr.rolling_dir.iterdir()) == ["epoch_0002.pt",
                                                                "epoch_0003.pt"]
    assert [f.name for f in mgr.best_dir.iterdir()] == ["epoch_0003.pt"]
    assert mgr.best_meta() == {"epoch": 3, "train_loss": 0.5, "test_loss": 0.25}
    assert not list(tmp_path.rglob("*.tmp"))


def test_ema_weights_go_to_the_best_checkpoint(corpora, tmp_path):
    cfg = _tiny_cfg(tmp_path, "train.ema_decay=0.9", "train.num_epochs=1")
    train_model(cfg, *corpora, device="cpu")
    work = tmp_path / "checkpoints"
    best = torch.load(next((work / "best").iterdir()), weights_only=True)
    raw = torch.load(work / "rolling" / "epoch_0001.pt", weights_only=True)
    assert best["optimizer"] is None and raw["optimizer"] is not None
    init = build_port_model(cfg.model, cfg.grid, device="cpu", seed=cfg.train.seed).state_dict()
    k = "head.fc.weight"
    # three steps of decay 0.9: the shadow lies between the start and the raw weights
    d_ema = (best["state_dict"][k] - init[k]).norm()
    d_raw = (raw["state_dict"][k] - init[k]).norm()
    assert 0 < d_ema < d_raw
    assert torch.equal(best["state_dict"]["encoder.stem_bn.running_mean"],
                       raw["state_dict"]["encoder.stem_bn.running_mean"])


def test_cosine_schedule_owns_the_learning_rate(corpora, tmp_path):
    cfg = _tiny_cfg(tmp_path, "train.lr_schedule=cosine", "train.warmup_steps=2",
                    "train.save_every_n_epochs=9")
    _, history = train_model(cfg, *corpora, device="cpu")
    sched = port_trainer.WarmupCosine(peak=1e-3, total_steps=6, warmup_steps=2)
    assert history["lr"] == [sched(2), sched(5)]  # the last step of each epoch
    with pytest.raises(ValueError, match="lr_schedule"):
        train_model(_tiny_cfg(tmp_path, "train.lr_schedule=step"), *corpora, device="cpu")


def test_non_finite_loss_aborts_with_an_emergency_checkpoint(corpora, tmp_path):
    cfg = _tiny_cfg(tmp_path, "train.learning_rate=1e30")
    _, history = train_model(cfg, *corpora, device="cpu")
    work = tmp_path / "checkpoints"
    assert history["aborted_epoch"] == 1 and history["train_losses"] == []
    assert (work / "rolling" / "epoch_0001.pt").exists()
    assert not (work / "metrics.jsonl").exists() and not list((work / "best").iterdir())


def test_sigterm_saves_a_checkpoint_that_resume_continues(corpora, tmp_path, monkeypatch):
    import signal

    cfg = _tiny_cfg(tmp_path)
    placed = []

    def place_then_signal(batch, device):
        placed.append(batch.n_valid)
        if len(placed) == 2:  # while the first epoch's batches are being placed
            signal.raise_signal(signal.SIGTERM)
        return real_place(batch, device)

    real_place = port_trainer.place_batch
    monkeypatch.setattr(port_trainer, "place_batch", place_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    state, history = train_model(cfg, *corpora, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before  # the guard put the handler back
    work = tmp_path / "checkpoints"
    assert history["preempted_epoch"] == 1 and history["train_losses"] == []
    assert 1 <= state.step < 3  # the epoch was cut short
    assert (work / "rolling" / "epoch_0001.pt").exists()
    monkeypatch.undo()
    _, resumed = train_model(cfg, *corpora, resume=True, device="cpu")
    assert [r["epoch"] for r in _records(work)] == [2] and resumed["total_epochs"] == 2


def test_cli_train_synthetic_on_the_cpu(tmp_path):
    overrides = [o for o in TINY if not o.startswith(("window.hop", "train.batch", "train.num"))]
    assert port_main(["train", "--synthetic", "--device", "cpu", f"data.base_path={tmp_path}",
                      *overrides, "window.hop_seconds=4.0", "train.batch_size=8",
                      "train.num_epochs=1"]) == 0
    work = tmp_path / "checkpoints"
    assert [r["epoch"] for r in _records(work)] == [1]
    assert (work / "training_history.json").exists() and list((work / "best").iterdir())


@pytest.mark.parametrize("override", ["train.prng_impl=rbg", "mesh.shard_params=true",
                                      "mesh.shard_opt_state=true"])
def test_override_of_an_unported_field_is_an_unknown_key(override):
    with pytest.raises(KeyError, match="unknown config field"):
        pc.parse_overrides(pc.Config(), [override])


@pytest.mark.parametrize("override,value", [
    ("train.log_every_steps=5", 5), ("features.use_pallas=false", False),
    ("features.power=1.0", 1.0), ("features.top_db=80", 80.0),
    ("targets.max_rows_per_chunk=128", 128)])
def test_override_of_a_field_nothing_reads_parses_as_in_jax(override, value):
    """The JAX package's fields that nothing of either package reads parse
    in the port, to the value and type JAX's parser gives them."""
    from seld_tpu.config import Config as JaxConfig
    from seld_tpu.config import parse_overrides as jax_parse

    path = override.split("=")[0]
    got = _field(pc.parse_overrides(pc.Config(), [override]), path)
    want = _field(jax_parse(JaxConfig(), [override]), path)
    assert got == want == value and type(got) is type(want)


def _field(cfg, path):
    for part in path.split("."):
        cfg = getattr(cfg, part)
    return cfg


@pytest.mark.parametrize("override,synthetic", [("targets.accdoa=true", True)])
def test_left_out_options_name_their_roadmap_item(override, synthetic, monkeypatch, tmp_path):
    """ACCDOA targets are ported; what is left out of their path, a process
    mesh of more than one rank, raises naming its ROADMAP item before any
    corpus is built or file written."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = ["train", "--device", "cpu", f"data.base_path={tmp_path}", override,
            "model.model_type=accdoa_conformer"]
    port_fails(args + (["--synthetic"] if synthetic else []),
               NotImplementedError, "ROADMAP item 10")
    assert not list(tmp_path.iterdir())


def test_distillation_under_a_mesh_names_its_roadmap_item(monkeypatch, tmp_path):
    """train.distill_ckpt under a process mesh of more than one rank raises
    naming ROADMAP item 10 before any corpus is built or file written."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    port_fails(["train", "--synthetic", "--device", "cpu", f"data.base_path={tmp_path}",
               f"train.distill_ckpt={tmp_path / 'teacher'}"],
               NotImplementedError, "ROADMAP item 10")
    assert not list(tmp_path.iterdir())


def test_one_rank_mesh_distilling_step_equals_the_unmeshed_step(small):
    """A distilling step on a 1-rank gloo mesh: loss, kd, hard, parameters
    and statistics bit-equal to the step without a mesh."""
    from functools import partial

    from seld_tpu_torch.distill import DistillSpec, grid_kd_loss
    from seld_tpu_torch.losses.seld_loss import make_class_weights
    from seld_tpu_torch.parallel.mesh import make_mesh
    from seld_tpu_torch.parallel.multihost import initialize_multihost

    _, variables, port_cfg = small
    teacher = _port_model(variables, port_cfg).requires_grad_(False).eval()
    spec = DistillSpec(teacher=teacher, alpha=0.5, temperature=2.0,
                       kd=partial(grid_kd_loss, class_weights=make_class_weights(14)))
    batch = _port_batch(*_batch(14, n_valid=3))
    runs = []
    for meshed in (False, True):
        mesh = None
        if meshed:
            assert initialize_multihost(torch.device("cpu"))
            mesh = make_mesh()
        try:
            port = _port_model(variables, port_cfg)
            opt = port_optimizer.make_optimizer(port.parameters(), 1e-3, 1e-4)
            step = make_port_train_step(port, PortLossFn(pc.LossConfig(), pc.GridConfig()),
                                        opt, 14, mesh=mesh, distill=spec)
            _, metrics = step(create_port_state(port, opt), *batch, (0, 1))
        finally:
            if meshed:
                torch.distributed.destroy_process_group()
        runs.append((port.state_dict(), metrics))
    (plain, want), (sharded, got) = runs
    assert set(got) == set(want) == {"loss", "class_mse", "hard", "kd"}
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(sharded[k], plain[k]) for k in plain)


def test_config_dict_of_the_jax_package_loads_in_the_port():
    from seld_tpu.config import Config, config_to_dict

    cfg = pc.config_from_dict(config_to_dict(Config()))  # unknown keys are ignored
    assert cfg == pc.Config()
    assert cfg.train.weight_decay == 1e-4 and cfg.window.hop_frames(cfg.features) == 50
