"""Knowledge distillation in the port (seld_tpu_torch/distill.py) against
seld_tpu.distill, on the CPU at tiny widths: the three KD losses and their
gradients against jax.grad, the track-permutation invariance of the
multi-ACCDOA KD, load_teacher's errors word for word against the JAX
package's and the KD it wires for each output kind, three distilling train
steps of a CRNN student under a Conformer teacher against JAX's distilling
step (with and without accumulation), alpha = 0 against the plain step,
the accumulated step's decomposition, a QAT distilling step with an
unquantized teacher, and `cli train` with train.distill_ckpt (its log line
against JAX's parameter count, kd / hard in metrics.jsonl, an exact
resume). Inputs are seeded numpy arrays handed to both packages; weights
cross through seld_tpu_torch.convert.state_dict_from_jax."""

import itertools
import json
import logging
import re
import shutil
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu import distill as jd
from seld_tpu.config import Config, GridConfig, LossConfig, parse_overrides
from seld_tpu.losses import SELDLossFn
from seld_tpu.losses.seld_loss import make_class_weights as jax_class_weights
from seld_tpu.models import build_model
from seld_tpu.train.optimizer import make_optimizer
from seld_tpu.train.state import TrainState
from seld_tpu.train.steps import make_train_step
from seld_tpu_torch import config as pc
from seld_tpu_torch import distill as pd
from seld_tpu_torch import quant
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.losses import SELDLossFn as PortLossFn
from seld_tpu_torch.losses.seld_loss import make_class_weights
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.train import optimizer as port_optimizer
from seld_tpu_torch.train.checkpoint import save_checkpoint
from seld_tpu_torch.train.state import create_train_state as create_port_state
from seld_tpu_torch.train.steps import make_train_step as make_port_train_step
from tests.test_torch_backbones import port_model, random_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import port_fails

RTOL, ATOL = 1e-5, 1e-6  # the KD losses and their gradients, float32 sums in other orders
STEP_RTOL = 1e-3  # three updates compound the float32 differences (test_torch_train.py)
STUDENT = ["model.model_type=crnn", "model.crnn_cnn_channels=8,16",
           "model.crnn_rnn_hidden=16", "model.crnn_rnn_layers=1",
           "model.compute_dtype=float32"]
TEACHER = ["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
           "model.conf_d_model=16", "model.conf_n_heads=2", "model.conf_n_layers=1",
           "model.compute_dtype=float32"]
MULTI = ["model.model_type=multi_accdoa_conformer", "model.crnn_cnn_channels=8,16",
         "model.conf_d_model=16", "model.conf_n_heads=2", "model.conf_n_layers=1",
         "model.compute_dtype=float32", "targets.accdoa=true", "targets.accdoa_tracks=3"]
B, T = 4, 6
ALPHA, TEMPERATURE = 0.5, 2.0


@pytest.fixture(autouse=True)
def remove_what_the_test_wrote(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# --- the KD losses -------------------------------------------------------------------


def _as_torch(x):
    return None if x is None else torch.from_numpy(x)


def _check_against_jax(port_fn, jax_fn, s, t, em, port_kw=None, jax_kw=None):
    """Value and gradient w.r.t. the student's output of port_fn against
    jax_fn (jax.value_and_grad) on the same numpy inputs."""
    want, want_grad = jax.value_and_grad(lambda x: jax_fn(x, t, em, **(jax_kw or {})))(s)
    x = torch.from_numpy(s).requires_grad_()
    got = port_fn(x, torch.from_numpy(t), _as_torch(em), **(port_kw or {}))
    got.backward()
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)
    return got.item()


EM = np.array([1.0, 0.0, 0.5], np.float32)  # a masked row and a fractional weight


def _grid_logits(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 4, 14, 6)).astype(np.float32) * 3
    return x


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "class_weights"])
@pytest.mark.parametrize("temperature", [1.0, 2.0, 4.0])
def test_grid_kd_loss_matches_jax(temperature, weighted, masked):
    s, t = _grid_logits(0), _grid_logits(1)
    t[:, :, 13] += 3.0  # a background-dominated teacher, so the weighting matters
    em = EM if masked else None
    port_kw, jax_kw = {"temperature": temperature}, {"temperature": temperature}
    if weighted:
        port_kw["class_weights"] = make_class_weights(14, 0.05)
        jax_kw["class_weights"] = jax_class_weights(14, 0.05)
    got = _check_against_jax(pd.grid_kd_loss, jd.grid_kd_loss, s, t, em, port_kw, jax_kw)
    assert got > 0
    same = pd.grid_kd_loss(torch.from_numpy(t), torch.from_numpy(t), _as_torch(em), **port_kw)
    assert abs(same.item()) < 1e-6  # KL(p || p) = 0


def _vectors(seed, shape):
    """ACCDOA vectors of lengths uniform in [0, 1]: about half the tracks
    active at the 0.5 decode threshold."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.uniform(0, 1, shape[:-1] + (1,))).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("background_weight", [None, 0.05], ids=["uniform", "activity"])
@pytest.mark.parametrize("shape", [(3, 4, 13, 3), (3, 4, 3, 13, 3)], ids=["accdoa", "multi"])
def test_vector_kd_loss_matches_jax(shape, background_weight, masked):
    kw = {"background_weight": background_weight}
    _check_against_jax(pd.vector_kd_loss, jd.vector_kd_loss, _vectors(2, shape),
                       _vectors(3, shape), EM if masked else None, kw, kw)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("background_weight", [None, 0.05], ids=["uniform", "activity"])
def test_multi_accdoa_kd_loss_matches_jax(background_weight, masked):
    shape = (3, 4, 3, 13, 3)
    s, t = _vectors(4, shape), _vectors(5, shape)
    kw = {"background_weight": background_weight}
    em = EM if masked else None
    got = _check_against_jax(pd.multi_accdoa_kd_loss, jd.multi_accdoa_kd_loss, s, t, em, kw, kw)
    slot_wise = pd.vector_kd_loss(*map(torch.from_numpy, (s, t)), _as_torch(em), **kw).item()
    assert got < slot_wise  # the identity ordering is one candidate of the min


def test_multi_accdoa_kd_is_invariant_to_the_teachers_track_order():
    """Every ordering of the teacher's tracks gives the same KD, bit for bit
    (the candidate set is the same and each candidate pairs the same
    elements); a student holding the teacher's tracks in another order has
    KD 0; the slot-wise KD is not invariant."""
    shape = (2, 5, 3, 13, 3)
    s, t = torch.from_numpy(_vectors(6, shape)), torch.from_numpy(_vectors(7, shape))
    em = torch.tensor([1.0, 0.5])
    for bg in (None, 0.05):
        want = pd.multi_accdoa_kd_loss(s, t, em, background_weight=bg)
        for perm in itertools.permutations(range(3)):
            assert torch.equal(pd.multi_accdoa_kd_loss(s, t[:, :, list(perm)], em,
                                                       background_weight=bg), want)
        assert pd.multi_accdoa_kd_loss(t[:, :, [1, 2, 0]], t, em, background_weight=bg) == 0
    assert pd.vector_kd_loss(t[:, :, [1, 2, 0]], t) > 0


def test_multi_accdoa_kd_ties_share_the_gradient_as_jax():
    """A teacher with two equal tracks makes two orderings tie: jnp.min
    splits the gradient between them, and so must the port (torch.amin)."""
    shape = (1, 2, 3, 13, 3)
    s, t = _vectors(8, shape), _vectors(9, shape)
    t[:, :, 1] = t[:, :, 0]
    _check_against_jax(pd.multi_accdoa_kd_loss, jd.multi_accdoa_kd_loss, s, t, None)


def test_multi_accdoa_kd_refuses_other_shapes_in_jax_words():
    s = _vectors(10, (3, 4, 13, 3))
    with pytest.raises(ValueError) as want:
        jd.multi_accdoa_kd_loss(s, s)
    with pytest.raises(ValueError) as got:
        pd.multi_accdoa_kd_loss(torch.from_numpy(s), torch.from_numpy(s))
    assert str(got.value) == str(want.value)


# --- load_teacher ----------------------------------------------------------------------


def _teacher_tree(root, overrides, epoch=2, sub="best", seed=3):
    """A seeded port model of the overrides saved as a checkpoint tree under
    root (one file in best/ or rolling/); returns (root, cfg, model)."""
    cfg = pc.parse_overrides(pc.Config(), overrides)
    model = build_port_model(cfg.model, cfg.grid, device="cpu", seed=seed)
    optimizer = port_optimizer.make_optimizer(model.parameters(), 1e-3)
    save_checkpoint(root / sub / f"epoch_{epoch:04d}.pt", model, cfg, epoch, optimizer,
                    meta={"epoch": epoch})
    return root, cfg, model


def test_load_teacher_restores_the_stored_architecture_in_eval_mode(tmp_path):
    """The teacher of another architecture than the student's, from its best
    file, else its newest rolling one: its weights, eval mode, no gradients,
    on the device named, and the checkpoint's meta."""
    root, _, saved = _teacher_tree(tmp_path / "a", TEACHER)
    cfg = pc.parse_overrides(pc.Config(), STUDENT)
    spec, meta = pd.load_teacher(cfg, root, "cpu")
    teacher = spec.teacher
    assert teacher.model_cfg.model_type == "conformer" and meta["epoch"] == 2
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    want = saved.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in teacher.state_dict().items())
    assert (spec.alpha, spec.temperature) == (0.5, 2.0)
    rolling, _, _ = _teacher_tree(tmp_path / "b", TEACHER, epoch=5, sub="rolling", seed=4)
    spec, meta = pd.load_teacher(cfg.replace_path("train.distill_alpha", 0.25), rolling, "cpu")
    assert meta["epoch"] == 5 and spec.alpha == 0.25


class _FakeJaxCheckpoints:
    """seld_tpu.train.checkpoint.CheckpointManager's restore with no orbax
    tree: what the JAX package's load_teacher reads after its checks."""

    restored = None

    def __init__(self, directory, cfg):
        pass

    def restore_best(self, template):
        return self.restored

    def restore_latest(self, template):
        return None

    def close(self):
        pass


def _jax_error(monkeypatch, cfg_overrides, stored_overrides, directory, restored=None):
    """The error seld_tpu.distill.load_teacher raises for a student of
    cfg_overrides and a stored teacher config of stored_overrides (None: no
    config), with the orbax reads replaced."""
    import seld_tpu.train.checkpoint as jax_checkpoint
    import seld_tpu.train.state as jax_state

    stored = None if stored_overrides is None else parse_overrides(Config(), stored_overrides)
    monkeypatch.setattr(jax_checkpoint, "load_checkpoint_config", lambda d: stored)
    monkeypatch.setattr(jax_checkpoint, "CheckpointManager",
                        type("Manager", (_FakeJaxCheckpoints,), {"restored": restored}))
    monkeypatch.setattr(jax_state, "create_train_state", lambda *a, **k: None)
    with pytest.raises((ValueError, FileNotFoundError)) as caught:
        jd.load_teacher(parse_overrides(Config(), cfg_overrides), directory, 50, 4)
    return caught.value


WINDOW = ["window.window_seconds=2.0"]
GRID = ["grid.cell_degrees=30"]
FEATURES = ["features.n_mels=40", "model.n_mels=40"]


@pytest.mark.parametrize("student,teacher", [
    (STUDENT + WINDOW, TEACHER),
    (STUDENT + GRID, TEACHER),
    (["model.model_type=accdoa_conformer"], TEACHER),
    (MULTI, ["model.model_type=conformer"]),
    (["model.model_type=accdoa_conformer"], MULTI),
], ids=["window", "grid", "grid_teacher_accdoa_student", "grid_teacher_multi_student",
        "multi_teacher_accdoa_student"])
def test_load_teacher_errors_are_jax_word_for_word(student, teacher, monkeypatch, tmp_path):
    root, _, _ = _teacher_tree(tmp_path, teacher)
    with pytest.raises(ValueError) as got:
        pd.load_teacher(pc.parse_overrides(pc.Config(), student), root, "cpu")
    assert str(got.value) == str(_jax_error(monkeypatch, student, teacher, root))


def test_load_teacher_features_error_names_the_section_as_jax(monkeypatch, tmp_path):
    """The features section: the port's FeatureConfig lacks three of the JAX
    package's fields (power, top_db, use_pallas), so the two reprs differ;
    the message up to them is JAX's."""
    root, _, _ = _teacher_tree(tmp_path, TEACHER)
    with pytest.raises(ValueError) as got:
        pd.load_teacher(pc.parse_overrides(pc.Config(), STUDENT + FEATURES), root, "cpu")
    want = str(_jax_error(monkeypatch, STUDENT + FEATURES, TEACHER, root))
    head = "train.distill_ckpt: teacher features config differs from the student's"
    assert str(got.value).startswith(head) and want.startswith(head)
    assert str(got.value).split("(teacher ")[0] == want.split("(teacher ")[0]


def test_load_teacher_missing_trees_are_jax_word_for_word(monkeypatch, tmp_path):
    """No checkpoint config; and a config with no checkpoint file beside it
    (the port reads both from one file, so the second is made by hiding
    the files after the config is read)."""
    import seld_tpu_torch.train.checkpoint as port_checkpoint

    cfg = pc.parse_overrides(pc.Config(), STUDENT)
    with pytest.raises(FileNotFoundError) as got:
        pd.load_teacher(cfg, tmp_path, "cpu")
    assert str(got.value) == str(_jax_error(monkeypatch, STUDENT, None, tmp_path))
    monkeypatch.setattr(port_checkpoint, "load_checkpoint_config",
                        lambda d: pc.parse_overrides(pc.Config(), TEACHER))
    with pytest.raises(FileNotFoundError) as got:
        pd.load_teacher(cfg, tmp_path, "cpu")
    assert str(got.value) == str(_jax_error(monkeypatch, STUDENT, TEACHER, tmp_path))


def test_load_teacher_track_matching_error_is_jax_word_for_word(monkeypatch, tmp_path):
    root, _, _ = _teacher_tree(tmp_path, MULTI)
    bad = [*MULTI, "train.distill_track_matching=nope"]
    with pytest.raises(ValueError) as got:
        pd.load_teacher(pc.parse_overrides(pc.Config(), bad), root, "cpu")
    jax_state = SimpleNamespace(params={}, batch_stats={})
    want = _jax_error(monkeypatch, bad, MULTI, root, restored=(jax_state, {}))
    assert str(got.value) == str(want)


@pytest.mark.parametrize("kind", ["grid", "accdoa", "multi_permutation", "multi_position"])
def test_load_teacher_wires_the_kd_of_its_kind(kind, tmp_path):
    """The KD load_teacher returns for each kind against the JAX package's
    function with the weights its load_teacher passes: the class weights of
    loss.background_class_weight (grid), the same value as the vector
    KDs' background weight; 1.0 makes either uniform."""
    overrides = {"grid": TEACHER, "accdoa": [*MULTI[1:6], "model.model_type=accdoa_conformer"],
                 "multi_permutation": MULTI,
                 "multi_position": [*MULTI, "train.distill_track_matching=position"]}[kind]
    root, _, _ = _teacher_tree(tmp_path, overrides)
    bg = 0.2
    shape = {"grid": (2, 3, 14, 5), "accdoa": (2, 3, 13, 3)}.get(kind, (2, 3, 3, 13, 3))
    if kind == "grid":
        s, t = _grid_logits(11)[:2, :3, :, :5], _grid_logits(12)[:2, :3, :, :5]
        t[:, :, 13] += 3.0
        jax_kd = partial(jd.grid_kd_loss, class_weights=jax_class_weights(14, bg))
    else:
        s, t = _vectors(11, shape), _vectors(12, shape)
        jax_kd = partial(jd.multi_accdoa_kd_loss if kind == "multi_permutation"
                         else jd.vector_kd_loss, background_weight=bg)
    for weight, differs in ((bg, True), (1.0, False)):
        cfg = pc.parse_overrides(pc.Config(), [*overrides, f"loss.background_class_weight={weight}"])
        spec, _ = pd.load_teacher(cfg, root, "cpu")
        got = spec.kd(torch.from_numpy(s), torch.from_numpy(t), None, temperature=TEMPERATURE)
        if differs:
            want = float(jax_kd(s, t, None, temperature=TEMPERATURE))
            np.testing.assert_allclose(got.item(), want, rtol=RTOL, atol=ATOL)
        uniform = {"grid": pd.grid_kd_loss, "multi_permutation": pd.multi_accdoa_kd_loss}.get(
            kind, pd.vector_kd_loss)(torch.from_numpy(s), torch.from_numpy(t), None,
                                     temperature=TEMPERATURE)
        assert (abs(got.item() - uniform.item()) > 1e-3 * uniform.item()) == differs


@pytest.mark.parametrize("model_type", ["crnn", "conformer", "resnet_conformer"])
def test_teacher_variable_count_is_flax_s(model_type):
    """Parameters plus BatchNorm statistics as flax counts them (jax.eval_shape,
    no init), at default widths: no num_batches_tracked, and without the
    GRU's hidden r and z biases."""
    cfg = parse_overrides(Config(), [f"model.model_type={model_type}"])
    model = build_model(cfg.model, cfg.grid)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init({"params": key, "dropout": key},
                                               jnp.zeros((1, 4, 4, 64)), train=False))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    pcfg = pc.parse_overrides(pc.Config(), [f"model.model_type={model_type}"])
    port = build_port_model(pcfg.model, pcfg.grid, device="meta", seed=None)
    assert pd.teacher_variable_count(port) == want


# --- the distilling train step ---------------------------------------------------------


def _batch(seed, n_valid=B):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, T, 4, 64)).astype(np.float32)
    mask = np.where(rng.random((B, T, 648)) < 0.9, 0,
                    rng.integers(1, 2 ** 13, (B, T, 648))).astype(np.uint16)
    em = (np.arange(B) < n_valid).astype(np.float32)
    return mel, mask, em


BATCHES = [_batch(20), _batch(21), _batch(22, n_valid=2)]  # the last a padded tail


def _port_batch(mel, mask, em):
    return torch.from_numpy(mel), torch.from_numpy(mask.view(np.int16)), torch.from_numpy(em)


@pytest.fixture(scope="module")
def pair():
    """(JAX student at dropout 0, its variables, JAX teacher, its variables):
    random variables of the tiny CRNN and the tiny Conformer."""
    x0 = jnp.zeros((B, T, 4, 64), jnp.float32)
    student = build_model(parse_overrides(Config(), STUDENT).model, GridConfig()).clone(
        dropout=0.0)
    teacher = build_model(parse_overrides(Config(), TEACHER).model, GridConfig())
    return student, random_variables(student, x0, seed=1), teacher, random_variables(
        teacher, x0, seed=2)


def _jax_spec(teacher, alpha=ALPHA):
    return jd.DistillSpec(apply=lambda v, x: teacher.apply(v, x, train=False),
                          kd=partial(jd.grid_kd_loss, class_weights=jax_class_weights(14, 0.05)),
                          alpha=alpha, temperature=TEMPERATURE)


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def jax_steps(request, pair):
    """(accum_steps, the metrics of JAX's three distilling steps), with
    flax's batch variance computed in two passes as the port does."""
    from flax.linen import normalization

    student, s_vars, teacher, t_vars = pair
    tx = make_optimizer(1e-3, 1e-4)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=s_vars["params"],
                       batch_stats=s_vars["batch_stats"], opt_state=tx.init(s_vars["params"]))
    fast = normalization._compute_stats
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(normalization, "_compute_stats",
                   lambda *a, **k: fast(*a, **{**k, "use_fast_variance": False}))
        step = make_train_step(student, SELDLossFn(LossConfig(), GridConfig()), tx, 14,
                               donate=False, accum_steps=request.param,
                               distill=_jax_spec(teacher))
        metrics = []
        for mel, mask, em in BATCHES:
            state, m = step(state, mel, mask, em, jax.random.PRNGKey(0), t_vars)
            metrics.append({k: float(v) for k, v in m.items()})
    return request.param, metrics


def _port_spec(t_vars, alpha=ALPHA):
    teacher = port_model(t_vars, TEACHER).requires_grad_(False).eval()
    return pd.DistillSpec(teacher=teacher,
                          kd=partial(pd.grid_kd_loss, class_weights=make_class_weights(14, 0.05)),
                          alpha=alpha, temperature=TEMPERATURE)


def _port_steps(pair, accum_steps=1, distill=None, qat=False, batches=BATCHES):
    """(student, the metrics of the port's steps on batches)."""
    _, s_vars, _, _ = pair
    student = port_model(s_vars, STUDENT, dropout=0.0)
    opt = port_optimizer.make_optimizer(student.parameters(), 1e-3, 1e-4)
    step = make_port_train_step(student, PortLossFn(pc.LossConfig(), pc.GridConfig()), opt,
                                14, accum_steps=accum_steps, distill=distill, qat=qat)
    state = create_port_state(student, opt)
    metrics = [step(state, *_port_batch(*b), (0, 1))[1] for b in batches]
    return student, metrics


def test_three_distilling_steps_match_jax(pair, jax_steps):
    """loss, hard and kd of each step at test_torch_train.py's bar; the
    breakdown's keys; the total is the blend."""
    accum_steps, want = jax_steps
    _, got = _port_steps(pair, accum_steps, distill=_port_spec(pair[3]))
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"loss", "class_mse", "hard", "kd"}
        assert not any(v.requires_grad for v in g.values())
        for k in ("loss", "hard", "kd"):
            np.testing.assert_allclose(g[k].item(), w[k], rtol=STEP_RTOL, err_msg=k)
        np.testing.assert_allclose(g["loss"].item(), (1 - ALPHA) * g["hard"].item()
                                   + ALPHA * g["kd"].item(), rtol=1e-6)


def test_alpha_zero_leaves_the_plain_step_bit_for_bit(pair):
    """alpha = 0: parameters, statistics and loss of three steps equal the
    plain step's bit for bit (the teacher draws nothing from any generator);
    kd is still reported."""
    plain, plain_metrics = _port_steps(pair)
    zero, zero_metrics = _port_steps(pair, distill=_port_spec(pair[3], alpha=0.0))
    want = plain.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in zero.state_dict().items())
    for p, z in zip(plain_metrics, zero_metrics):
        assert torch.equal(p["loss"], z["loss"]) and torch.equal(p["loss"], z["hard"])
        assert z["kd"].item() > 0


class _NoBN(torch.nn.Module):
    """A BatchNorm-free, dropout-free grid model ((B, T, C, F) -> (B, T, 14,
    648) through one hidden layer): the regime in which accumulation is
    exact (tests/test_distill.py::test_distill_accum_decomposes_exactly)."""

    compute_dtype = torch.float32

    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.hidden = torch.nn.Linear(4 * 64, 32)
        self.out = torch.nn.Linear(32, 14 * 648)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) / 16)

    def seed_dropout(self, seed):
        pass

    def forward(self, x):
        b, t = x.shape[:2]
        return self.out(torch.relu(self.hidden(x.reshape(b, t, -1)))).reshape(b, t, 14, 648)


def test_accumulated_distilling_step_decomposes_exactly():
    """As the JAX package's: at accum_steps 2 the kd, hard and total terms
    and the parameters after the update equal the full-batch step's."""
    teacher = _NoBN(9).requires_grad_(False).eval()
    spec = pd.DistillSpec(teacher=teacher, kd=pd.grid_kd_loss, alpha=0.7,
                          temperature=TEMPERATURE)
    mel, mask, em = _port_batch(*_batch(30))
    runs = []
    for accum in (1, 2):
        model = _NoBN(1)
        opt = port_optimizer.make_optimizer(model.parameters(), 1e-3)
        step = make_port_train_step(model, PortLossFn(pc.LossConfig(), pc.GridConfig()), opt,
                                    14, accum_steps=accum, distill=spec)
        runs.append((model, step(create_port_state(model, opt), mel, mask, em, (0, 1))[1]))
    (m1, r1), (m2, r2) = runs
    for k, rtol in (("kd", 1e-5), ("hard", 1e-5), ("loss", 1e-6)):
        np.testing.assert_allclose(r2[k].item(), r1[k].item(), rtol=rtol, err_msg=k)
    for (name, a), b in zip(m1.named_parameters(), m2.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_qat_distilling_step_leaves_the_teacher_unquantized(pair):
    """Under train.qat only the student fake-quantizes: the teacher's output
    inside the step is its plain eval forward bit for bit (and its forward
    under quant.qat() would differ), while the student's hard loss moves
    off the float step's."""
    spec = _port_spec(pair[3])
    seen = []
    hook = spec.teacher.register_forward_hook(lambda m, i, out: seen.append((i[0], out)))
    try:
        _, qat_metrics = _port_steps(pair, distill=spec, qat=True, batches=BATCHES[:1])
    finally:
        hook.remove()
    (mel, inside), = seen
    with torch.no_grad():
        assert torch.equal(inside, spec.teacher(mel))
        with quant.qat():
            assert not torch.equal(inside, spec.teacher(mel))
    _, float_metrics = _port_steps(pair, distill=spec, batches=BATCHES[:1])
    assert qat_metrics[0]["hard"].item() != float_metrics[0]["hard"].item()


# --- the trainer through the CLI -------------------------------------------------------

COMMON = ["model.compute_dtype=float32", "window.window_seconds=1.0",
          "window.hop_seconds=4.0", "train.batch_size=8", "train.save_every_n_epochs=1"]
LINE = re.compile(r"Distillation: teacher (\w+) \(epoch (\d+), ([\d,]+) params\) -> "
                  r"student (\w+); alpha=([\d.]+) temperature=([\d.]+)$")


def test_cli_train_distills_logs_jax_s_count_and_resumes_exactly(tmp_path, caplog):
    """`cli train --synthetic train.distill_ckpt=DIR` of a tiny CRNN under a
    tiny Conformer teacher: JAX's log line with the teacher's flax variable
    count, kd and hard in metrics.jsonl's train records only (the total
    their blend), and one epoch resumed into a second equal to two epochs
    straight."""
    teacher_dir, _, _ = _teacher_tree(tmp_path / "teacher",
                                      TEACHER + COMMON)
    jcfg = parse_overrides(Config(), TEACHER)
    jax_teacher = build_model(jcfg.model, jcfg.grid)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jax_teacher.init({"params": key, "dropout": key},
                                                     jnp.zeros((1, 50, 4, 64)), train=False))
    jax_count = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    student = [*STUDENT[:-1], *COMMON, f"data.base_path={tmp_path}",
               f"train.distill_ckpt={teacher_dir}", "train.distill_alpha=0.6",
               "train.distill_temperature=3.0"]
    with caplog.at_level(logging.INFO, logger="seld_tpu_torch"):
        assert port_main(["train", "--synthetic", "--device", "cpu", *student,
                          "train.num_epochs=2",
                          "data.checkpoint_dirname=straight"]) == 0
    (line,) = [m for m in (LINE.search(r.getMessage()) for r in caplog.records) if m]
    assert line.groups() == ("conformer", "2", f"{jax_count:,}", "crnn", "0.6", "3")
    records = [json.loads(x) for x in (tmp_path / "straight" / "metrics.jsonl").read_text()
               .splitlines()]
    assert [r["epoch"] for r in records] == [1, 2]
    for r in records:
        assert {"kd", "hard"} <= set(r["train"]) and not {"kd", "hard"} & set(r["test"])
        assert np.isfinite([r["train"]["kd"], r["train"]["hard"]]).all()
        np.testing.assert_allclose(r["train"]["loss"], 0.4 * r["train"]["hard"]
                                   + 0.6 * r["train"]["kd"], rtol=1e-5)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="seld_tpu_torch"):
        for extra, epochs in (([], 1), (["--resume"], 2)):
            assert port_main(["train", "--synthetic", "--device", "cpu", *extra, *student,
                              f"train.num_epochs={epochs}", "data.checkpoint_dirname=split"]) == 0
    assert sum(bool(LINE.search(r.getMessage())) for r in caplog.records) == 2
    resumed = [json.loads(x) for x in (tmp_path / "split" / "metrics.jsonl").read_text()
               .splitlines()]
    assert [r["epoch"] for r in resumed] == [1, 2]
    assert resumed[1]["train"] == records[1]["train"] and resumed[1]["test"] == records[1]["test"]


@pytest.mark.parametrize("override,match", [
    ("train.distill_alpha=1.5", r"train.distill_alpha must be in \[0, 1\], got 1.5"),
    ("train.distill_temperature=0.0",
     r"train.distill_temperature must be > 0 \(it divides the logits inside the KD loss\), "
     r"got 0.0"),
])
def test_cli_train_refuses_bad_distill_knobs_before_writing(override, match, tmp_path):
    teacher_dir, _, _ = _teacher_tree(tmp_path / "teacher",
                                      TEACHER + COMMON)
    port_fails(["train", "--synthetic", "--device", "cpu", *STUDENT[:-1], *COMMON,
               f"data.base_path={tmp_path / 'run'}", f"train.distill_ckpt={teacher_dir}",
               override], ValueError, match)
    assert not (tmp_path / "run" / "checkpoints" / "best").exists()


def test_distill_fields_parse_and_round_trip():
    cfg = pc.parse_overrides(pc.Config(), ["train.distill_ckpt=/x/y", "train.distill_alpha=0.3",
                                           "train.distill_temperature=4",
                                           "train.distill_track_matching=position"])
    assert (cfg.train.distill_ckpt, cfg.train.distill_alpha, cfg.train.distill_temperature,
            cfg.train.distill_track_matching) == ("/x/y", 0.3, 4.0, "position")
    assert pc.config_from_dict(pc.config_to_dict(cfg)) == cfg
    jax_defaults = Config().train
    assert all(getattr(pc.TrainConfig(), f) == getattr(jax_defaults, f) for f in (
        "distill_ckpt", "distill_alpha", "distill_temperature", "distill_track_matching"))
