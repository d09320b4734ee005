"""The port's ACCDOA families against seld_tpu's, on the CPU: targets,
losses and their gradients, every decode, both models at a tiny width on
converted weights (eval and train mode, BatchNorm statistics, gradients),
the parameter counts at the default widths, the converter's refusals, the
ACS hook for ACCDOA targets, the corpus, cache and sampler, and
`evaluate_model` with an activity threshold and its sweep on a tiny run
that the port trains, held to the JAX package's decodes and metrics on the
same outputs. Every test removes what it writes."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu import accdoa as ja
from seld_tpu.config import Config, parse_overrides
from seld_tpu.eval import metrics as jax_metrics
from seld_tpu.features.acs import make_acs_augment_accdoa as jax_acs_accdoa
from seld_tpu.losses.seld_loss import _bit_labels
from seld_tpu.models import build_model
from seld_tpu_torch import accdoa as pa
from seld_tpu_torch import config as pc
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.data.sampler import BatchIterator, place_batch
from seld_tpu_torch.data.synthetic import synthetic_corpus
from seld_tpu_torch.eval import evaluate_model
from seld_tpu_torch.features.acs import apply_acs_accdoa, make_acs_augment_accdoa
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.train.checkpoint import checkpoint_file
from seld_tpu_torch.train.trainer import train_model
from tests.test_torch_backbones import port_model, random_variables, two_pass_variance
from tests.test_torch_eval import _assert_same
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

C = 13  # event classes
TINY = {
    "accdoa_conformer": ["model.model_type=accdoa_conformer", "model.crnn_cnn_channels=8,16",
                         "model.conf_d_model=32", "model.conf_n_heads=2",
                         "model.conf_n_layers=1"],
    "multi_accdoa_conformer": ["model.model_type=multi_accdoa_conformer",
                               "model.crnn_cnn_channels=8,16", "model.conf_d_model=32",
                               "model.conf_n_heads=2", "model.conf_n_layers=1"],
}
F32 = ["model.compute_dtype=float32"]
B, T = 4, 6
# eval mode: tests/test_torch_backbones.py's bar
ATOL, RTOL = 5e-4, 1e-3
# losses and their gradients in float32: sums in another order
LOSS_TOL = dict(rtol=1e-6, atol=1e-7)


# --- targets ----------------------------------------------------------------


def _metadata(seed, n_frames=12):
    """Rows with 1, 2, 3 and 4 sources of one class in one frame (frame 2:
    class 4 once; frame 3: class 5 twice; frame 4: class 6 three times;
    frame 5: class 7 four times), random rows elsewhere, and rows past the
    end of the labels."""
    rng = np.random.default_rng(seed)
    rows = [(2, 4), (3, 5), (3, 5), (4, 6), (4, 6), (4, 6), (5, 7), (5, 7), (5, 7), (5, 7)]
    free = np.r_[0:2, 6:n_frames + 3]  # the other frames
    rows += [(int(f), int(c)) for f, c in zip(rng.choice(free, 20), rng.integers(0, C, 20))]
    frames = np.array([r[0] for r in rows], np.int64)
    classes = np.array([r[1] for r in rows], np.int64)
    az = rng.integers(-180, 180, len(rows))
    el = rng.integers(-90, 91, len(rows))
    return frames, classes, az, el


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["rasterize_accdoa_targets", "rasterize_adpit_targets"])
def test_targets_equal_jax(name, seed):
    frames, classes, az, el = _metadata(seed)
    for total in (60, 23):  # every row inside; the last rows cut
        got = getattr(pa, name)(frames, classes, az, el, total)
        want = getattr(ja, name)(frames, classes, az, el, total)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    adpit = pa.rasterize_adpit_targets(frames, classes, az, el, 60)
    # 1, 2 and 3 sources fill slots 0, 1-2 and 3-5; a fourth is dropped
    assert adpit[10:15, 0, 0, 4].all() and adpit[15:20, 1:3, 0, 5].all()
    assert adpit[20:25, 3:6, 0, 6].all() and adpit[25:30, 3:6, 0, 7].all()
    assert pa.rasterize_accdoa_targets(frames[:0], classes[:0], az[:0], el[:0], 5).shape == (
        5, C, 3)
    np.testing.assert_array_equal(pa.doa_unit_vector(az, el), ja.doa_unit_vector(az, el))


# --- losses -----------------------------------------------------------------


def _adpit_case(seed, b=3, t=5):
    """(pred (B, T, 3, C, 3), ADPIT targets (B, T, 6, 4, C)) from rows with
    one, two and three sources of a class, so that the padded candidates
    tie; and one constructed tie between two different assignments."""
    rng = np.random.default_rng(seed)
    targets = np.stack([pa.rasterize_adpit_targets(*_metadata(seed + i, 2), t)
                        for i in range(b)])
    pred = np.tanh(rng.standard_normal((b, t, 3, C, 3))).astype(np.float32)
    # two sources of class 0 at frame 0 of sample 0 along x and y: tracks
    # (x, mid, y) with mid exactly between them tie (B0 B0 B1) with (B0 B1 B1)
    targets[0, 0, :, :, 0] = 0.0
    targets[0, 0, 1, :, 0] = [1.0, 1.0, 0.0, 0.0]
    targets[0, 0, 2, :, 0] = [1.0, 0.0, 1.0, 0.0]
    pred[0, 0, :, 0] = [[1.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.0, 1.0, 0.0]]
    return pred, targets


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_accdoa_loss_and_gradient_equal_jax(seed, masked):
    rng = np.random.default_rng(seed)
    pred = np.tanh(rng.standard_normal((3, 5, C, 3))).astype(np.float32)
    target = np.stack([pa.rasterize_accdoa_targets(*_metadata(seed + i, 2), 5)
                       for i in range(3)])
    em = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    want, want_grad = jax.value_and_grad(ja.accdoa_loss)(pred, target, em)
    p = torch.from_numpy(pred).requires_grad_()
    got = pa.accdoa_loss(p, torch.from_numpy(target), None if em is None else torch.from_numpy(em))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), **LOSS_TOL)
    total, parts = pa.ACCDOALossFn()(p, torch.from_numpy(target))
    assert list(parts) == ["accdoa"] and parts["accdoa"] is total


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adpit_loss_and_gradient_equal_jax_with_ties(seed, masked):
    """Inapplicable candidates tie with the applicable one by design, and
    the constructed case ties two assignments that differ: jnp.min splits
    its gradient evenly among ties, and so must the port (torch.amin)."""
    pred, targets = _adpit_case(seed)
    em = np.array([1.0, 1.0, 0.0], np.float32) if masked else None
    want, want_grad = jax.value_and_grad(ja.adpit_loss)(pred, targets, em)
    p = torch.from_numpy(pred).requires_grad_()
    got = pa.adpit_loss(p, torch.from_numpy(targets), None if em is None else torch.from_numpy(em))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), **LOSS_TOL)
    # the constructed tie: 8 of the 13 candidates are (B0 B0 B1) (the A and
    # C candidates padded to it) and one (B0 B1 B1); the middle track's
    # gradient is their mean, 8 parts toward x and one toward y, where
    # torch.min(dim=...) would send all of it one way
    g = p.grad.numpy()[0, 0, 1, 0]
    assert g[0] == -g[1] < 0
    total, parts = pa.ADPITLossFn()(p, torch.from_numpy(targets))
    assert list(parts) == ["adpit"] and parts["adpit"] is total


# --- decodes ----------------------------------------------------------------


def _vectors(seed, lead, threshold):
    """Random vectors, some inactive, two classes sharing a direction (so a
    cell), and norms at the threshold and one float32 ulp either side."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((*lead, C, 3)) * rng.uniform(0, 1, (*lead, C, 1)))
    v = v.astype(np.float32)
    v[..., 7, :] = 2.0 * v[..., 2, :]  # class 7 in class 2's cell, when both are active
    v[..., 9, :] = 3.0 * v[..., 2, :]
    th = np.float32(threshold)
    flat = v.reshape(-1, C, 3)
    for k, norm in enumerate((np.nextafter(th, np.float32(0)), th,
                              np.nextafter(th, np.float32(2)))):
        flat[k::3, 11] = [norm, 0.0, 0.0]  # sqrt(n * n) == n in float32
        flat[k::3, 12] = [0.0, 0.0, -norm]
    return v


@pytest.mark.parametrize("threshold", [0.5, 0.3, 0.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_single_accdoa_decodes_equal_jax(seed, threshold):
    v = _vectors(seed, (4, 30), threshold)
    want = np.asarray(ja.decode_accdoa_to_grid_jnp(jnp.asarray(v), 18, 36, 14, threshold))
    got = pa.decode_accdoa_to_grid(torch.from_numpy(v), 18, 36, 14, threshold)
    assert got.dtype == torch.int8 and got.shape == (4, 30, 648)
    np.testing.assert_array_equal(got.numpy(), want)
    host = pa.decode_accdoa_to_grid_np(v, 18, 36, 14, threshold)
    np.testing.assert_array_equal(host, ja.decode_accdoa_to_grid(v, 18, 36, 14, threshold))
    if threshold:  # the ulp cases: at the threshold and below it inactive, above active
        flat = got.numpy().reshape(-1, 648)
        assert not (flat[0::3] == 11).any() and not (flat[1::3] == 11).any()
        assert (flat[2::3] == 11).sum(axis=1).min() == 1
    # the shared cell: the highest class paints it, on the device and the host
    assert (got.numpy() == 9).any() and (got.numpy() == host).all()
    again = pa.decode_accdoa_to_grid(torch.from_numpy(v), 18, 36, 14, threshold)
    assert torch.equal(again, got)


@pytest.mark.parametrize("threshold", [0.5, 0.4])
@pytest.mark.parametrize("seed", [0, 1])
def test_multi_accdoa_decodes_equal_jax(seed, threshold):
    v = np.stack([_vectors(seed + k, (3, 20), threshold) for k in range(3)], axis=2)
    v[:, :, 1, 4] = v[:, :, 0, 4] * 0.9  # two tracks of one class in one cell
    jv = jnp.asarray(v)
    args = (18, 36, 14, threshold)
    want = np.asarray(ja.decode_multi_accdoa_to_grid_jnp(jv, *args))
    got = pa.decode_multi_accdoa_to_grid(torch.from_numpy(v), *args)
    np.testing.assert_array_equal(got.numpy(), want)
    act = pa.multi_accdoa_class_activity(torch.from_numpy(v), 18, 36, threshold)
    want_act = np.asarray(ja.multi_accdoa_class_activity_jnp(jv, 18, 36, threshold))
    assert act.shape == (3, 20, C, 648) and act.dtype == torch.float32
    np.testing.assert_array_equal(act.numpy(), want_act)
    np.testing.assert_array_equal(pa.decode_vote_grid(act, 14).numpy(), want)
    np.testing.assert_array_equal(
        pa.decode_multi_accdoa_to_grid_np(v, *args), ja.decode_multi_accdoa_to_grid(v, *args))


@pytest.mark.parametrize("min_vote", [0.5, 0.25])
def test_vote_decodes_equal_jax(min_vote):
    rng = np.random.default_rng(3)
    votes = rng.choice(np.float32([0, 0.25, 0.5, 0.75, 1]), (2, 10, C, 648)).astype(np.float32)
    votes[..., 3, :] = votes[..., 8, :]  # ties: the higher class wins
    want = np.asarray(ja.decode_vote_grid_jnp(jnp.asarray(votes), 14, min_vote))
    np.testing.assert_array_equal(pa.decode_vote_grid(torch.from_numpy(votes), 14,
                                                      min_vote).numpy(), want)
    np.testing.assert_array_equal(pa.decode_vote_grid_np(votes, 14, min_vote),
                                  ja.decode_vote_grid(votes, 14, min_vote))
    np.testing.assert_array_equal(ja.decode_vote_grid(votes, 14, min_vote), want)


# --- models -----------------------------------------------------------------


@pytest.fixture(scope="module", params=sorted(TINY))
def family(request):
    """(name, JAX model, random numpy variables, float32 overrides)."""
    overrides = TINY[request.param] + F32
    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid)
    return request.param, model, random_variables(model, jnp.zeros((B, T, 4, 64))), overrides


def _input(seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, 4, 64)).astype(np.float32)


def _out_shape(name):
    return (B, T, 3, C, 3) if name.startswith("multi") else (B, T, C, 3)


def test_eval_output_matches_jax(family):
    name, model, variables, overrides = family
    x = _input()
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x))
    with torch.no_grad():
        got = port_model(variables, overrides)(torch.from_numpy(x))
    assert got.shape == want.shape == _out_shape(name) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_bf16_output_matches_jax(family):
    """The default compute dtype: the head's Linear in bf16, tanh in
    float32 on both sides. Against flax's float32 output the port's bf16
    error is at most 1.5x flax's own bf16 error (RMS; measured 1.01x and
    0.87x), and the two bf16 outputs differ by at most 0.05 on outputs
    bounded by 1 (measured 0.028 and 0.018)."""
    name, model, variables, overrides = family
    x = _input(7)
    exact = np.asarray(model.apply(variables, x, train=False))
    want = np.asarray(model.clone(dtype=jnp.bfloat16).apply(variables, x, train=False))
    with torch.no_grad():
        got = port_model(variables, [o for o in overrides if o not in F32])(
            torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.numpy()

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a - exact))))

    assert rms(got) <= 1.5 * rms(want)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=0)


def test_train_mode_output_and_statistics_match_jax(family, monkeypatch):
    """One train-mode forward at dropout 0: outputs to 1e-4 against flax with
    a two-pass variance, and every updated BatchNorm statistic to 1e-5."""
    _, model, variables, overrides = family
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
    assert stats and any(not torch.equal(want_state[k], before[k]) for k in stats)
    got_state = port.state_dict()
    for k in stats:
        np.testing.assert_allclose(got_state[k].numpy(), want_state[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_train_mode_gradients_match_jax(family, monkeypatch):
    """Every parameter's gradient of a seeded linear functional of the
    train-mode output, by tests/test_torch_backbones.py's rule."""
    name, model, variables, overrides = family
    model = model.clone(dropout=0.0)
    x = _input(3)
    w = np.random.default_rng(9).standard_normal(_out_shape(name)).astype(np.float32)
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
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max() + 1e-5 * largest,
                                   err_msg=pname)
        checked += 1
    assert checked >= 30


@pytest.mark.parametrize("model_type", sorted(TINY))
def test_parameter_counts_match_jax_at_default_widths(model_type):
    cfg = parse_overrides(Config(), [f"model.model_type={model_type}"])
    model = build_model(cfg.model, cfg.grid)
    x0 = jnp.zeros((1, 4, 4, 64), jnp.float32)
    shapes = jax.eval_shape(lambda r: model.init({"params": r, "dropout": r}, x0,
                                                 train=False), jax.random.PRNGKey(0))
    want = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(shapes["params"]))
    pcfg = pc.parse_overrides(pc.Config(), [f"model.model_type={model_type}"])
    port = build_port_model(pcfg.model, pcfg.grid, device="meta", seed=None)
    assert sum(p.numel() for p in port.parameters()) == want


def test_converter_raises_on_missing_and_unknown_keys(family):
    _, _, variables, overrides = family
    cfg = pc.parse_overrides(pc.Config(), overrides).model
    broken = jax.tree.map(lambda x: x, variables)
    del broken["params"]["accdoa"]["bias"]
    with pytest.raises(KeyError, match="accdoa/bias"):
        state_dict_from_jax(broken, cfg)
    extra = jax.tree.map(lambda x: x, variables)
    extra["params"]["GridHead_0"] = {"Dense_0": extra["params"]["proj"]}
    with pytest.raises(KeyError, match="does not know"):
        state_dict_from_jax(extra, cfg)


def test_remat_recomputes_the_blocks_with_the_same_gradients():
    """remat (threaded as the Conformer's) changes the memory, not the
    numbers: the same train-mode gradients at dropout 0.3."""
    base = pc.parse_overrides(pc.Config(), TINY["multi_accdoa_conformer"] + F32)
    x = torch.from_numpy(_input(4))
    grads = []
    for remat in ("none", "conformer"):
        cfg = base.replace_path("model.remat", remat)
        model = build_port_model(cfg.model, cfg.grid, device="cpu", seed=3).train()
        assert model.remat_blocks == (remat == "conformer")
        model.seed_dropout(11)
        model(x).square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5, atol=1e-7)


# --- ACS --------------------------------------------------------------------


@pytest.mark.parametrize("multi", [False, True])
def test_acs_hook_equals_jax_for_every_transform(multi, monkeypatch):
    """All 16 transforms at once, one per sample: JAX's draw fixed to
    0..15, the port given the same indices. Gathers and sign flips are
    exact, so features and targets are equal to the bit."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((16, 5, 7, 8)).astype(np.float32)
    shape = (16, 5, 6, 4, C) if multi else (16, 5, C, 3)
    targets = rng.standard_normal(shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.arange(16))
    want_f, want_t = jax_acs_accdoa("mel_iv", multi=multi)(jax.random.PRNGKey(0), feats,
                                                           targets)
    got_f, got_t = apply_acs_accdoa(torch.from_numpy(feats), torch.from_numpy(targets),
                                    torch.arange(16), multi)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    if multi:  # the activity channel stays
        np.testing.assert_array_equal(got_t[:, :, :, 0].numpy(), targets[:, :, :, 0])
    hook = make_acs_augment_accdoa("mel_iv", multi)
    g = torch.Generator().manual_seed(0)
    out = hook(g, torch.from_numpy(feats), torch.from_numpy(targets))
    assert out[1].shape == shape
    with pytest.raises(ValueError, match="signed spatial features"):
        make_acs_augment_accdoa("mel", multi)


# --- corpus, cache, sampler ---------------------------------------------------

CORPUS = ["window.window_seconds=1.0", "window.hop_seconds=0.5", "targets.accdoa=true"]


@pytest.mark.parametrize("tracks", [1, 3])
def test_corpus_accdoa_targets_equal_jax(tracks):
    from seld_tpu.data.synthetic import synthetic_corpus as jax_synthetic_corpus

    over = [*CORPUS, f"targets.accdoa_tracks={tracks}"]
    want = jax_synthetic_corpus(parse_overrides(Config(), over), n_files=2, seconds=3.0, seed=4)
    got = synthetic_corpus(pc.parse_overrides(pc.Config(), over), n_files=2, seconds=3.0,
                           seed=4, device="cpu")
    assert got.accdoa.shape == want.accdoa.shape and got.accdoa.any()
    assert got.accdoa.shape[1:] == ((6, 4, C) if tracks > 1 else (C, 3))
    np.testing.assert_array_equal(got.accdoa, want.accdoa)
    idx = np.array([len(got) - 1, 0])
    np.testing.assert_array_equal(got.gather_accdoa(idx), want.gather_accdoa(idx))
    batch = next(iter(BatchIterator(got, 3, shuffle=False, prefetch=0)))
    placed = place_batch(batch, torch.device("cpu"))
    assert len(placed) == 4 and placed[3].dtype == torch.float32
    np.testing.assert_array_equal(placed[3].numpy(), got.gather_accdoa(np.arange(3)))


def test_cache_keys_on_accdoa_and_stores_the_targets(tmp_path):
    from seld_tpu_torch.data.cache import _load_corpus, _save_corpus, corpus_cache_key
    from seld_tpu_torch.data.synthetic import synthetic_raw_files

    cfg = pc.parse_overrides(pc.Config(), CORPUS)
    wavs, csvs = synthetic_raw_files(tmp_path / "raw", cfg, n_files=1, seconds=2.0)
    parts = (cfg.features, cfg.grid, cfg.window)
    keys = {corpus_cache_key(wavs, csvs, *parts, t, True) for t in (
        cfg.targets, pc.parse_overrides(cfg, ["targets.accdoa=false"]).targets,
        pc.parse_overrides(cfg, ["targets.accdoa_tracks=3"]).targets)}
    assert len(keys) == 3  # a grid-only entry never serves an ACCDOA request
    corpus = synthetic_corpus(cfg, n_files=1, seconds=2.0, device="cpu")
    _save_corpus(tmp_path / "c.npz", corpus, "k")
    back = _load_corpus(tmp_path / "c.npz", "k")
    np.testing.assert_array_equal(back.accdoa, corpus.accdoa)
    shutil.rmtree(tmp_path, ignore_errors=True)


# --- evaluation on a tiny run -------------------------------------------------

RUN = ["model.crnn_cnn_channels=8,16", "model.conf_d_model=16", "model.conf_n_heads=2",
       "model.conf_n_layers=1", "model.compute_dtype=float32", "window.window_seconds=0.4",
       "window.hop_seconds=0.4", "train.batch_size=4", "train.num_epochs=1",
       "targets.accdoa=true"]
SWEEP = [0.1, 0.3, 0.5]


@pytest.fixture(scope="module", params=sorted(TINY))
def run(request, tmp_path_factory):
    """A one-epoch run of a tiny ACCDOA model, the best checkpoint chosen on
    SELD_error: (cfg, workdir, test corpus, multi)."""
    base = tmp_path_factory.mktemp("accdoa_eval")
    multi = request.param.startswith("multi")
    cfg = pc.parse_overrides(pc.Config(), [
        *RUN, f"model.model_type={request.param}", f"data.base_path={base}",
        f"targets.accdoa_tracks={3 if multi else 1}", "train.select_metric=seld_error"])
    train_c = synthetic_corpus(cfg, n_files=1, seconds=3.0, seed=0, event_rate_hz=3.0,
                               device="cpu")
    test_c = synthetic_corpus(cfg, n_files=1, seconds=3.0, seed=1, train=False,
                              event_rate_hz=3.0, device="cpu")
    _, history = train_model(cfg, train_c, test_c, device="cpu")
    assert np.isfinite(history["train_losses"]).all() and "best_val_metric" in history
    yield cfg, base / "checkpoints", test_c, multi
    shutil.rmtree(base, ignore_errors=True)


def test_evaluate_model_holds_to_jax_decodes_and_metrics(run):
    """The report at threshold 0.4 and its sweep are the JAX package's
    decodes and metrics of the port's outputs, number for number, and its
    loss JAX's loss of those outputs."""
    cfg, work, test_c, multi = run
    report = evaluate_model(cfg, test_c, work, accdoa_threshold=0.4,
                            accdoa_threshold_sweep=SWEEP, device="cpu",
                            save_visualizations=False)
    blob = torch.load(checkpoint_file(work, "best"), weights_only=True)
    model = build_port_model(cfg.model, cfg.grid, device="cpu", seed=None)
    model.load_state_dict(blob["state_dict"])
    decode = ja.decode_multi_accdoa_to_grid_jnp if multi else ja.decode_accdoa_to_grid_jnp
    loss = ja.adpit_loss if multi else ja.accdoa_loss
    losses, preds, trues, swept = [], [], [], {th: [] for th in SWEEP}
    for batch in BatchIterator(test_c, cfg.train.batch_size, shuffle=False, prefetch=0):
        with torch.no_grad():
            out = jnp.asarray(model(torch.from_numpy(batch.mel)).numpy())
        em = (np.arange(batch.mel.shape[0]) < batch.n_valid).astype(np.float32)
        losses.append(float(loss(out, batch.accdoa, em)))
        n = batch.n_valid
        preds.append(np.asarray(decode(out, 18, 36, 14, 0.4))[:n])
        trues.append(np.asarray(_bit_labels(jnp.asarray(batch.label_mask), 14)).astype(
            np.int8)[:n])
        for th in SWEEP:
            swept[th].append(np.asarray(decode(out, 18, 36, 14, th))[:n])
    pred, true = np.concatenate(preds), np.concatenate(trues)
    key = "adpit" if multi else "accdoa"
    assert report["test_loss"] == pytest.approx(float(np.mean(losses)), rel=1e-6, abs=1e-7)
    assert report[key] == report["test_loss"] and report["accdoa_threshold"] == 0.4
    _assert_same(report["dcase2022"], jax_metrics.dcase2022_metrics(pred, true, 18, 36, 14))
    _assert_same(report["dcase"], jax_metrics.seld_metrics(pred, true, 18, 36, 14))
    sweep = report["accdoa_threshold_sweep"]
    assert list(sweep["metrics"]) == [repr(th) for th in SWEEP]
    for th in SWEEP:
        want = jax_metrics.dcase2022_metrics(np.concatenate(swept[th]), true, 18, 36, 14)
        _assert_same(sweep["metrics"][repr(th)],
                     {k: float(want[k]) for k in sweep["metrics"][repr(th)]})
    best = min(SWEEP, key=lambda th: sweep["metrics"][repr(th)]["SELD_error"])
    assert sweep["best"] == {"accdoa_threshold": best, **sweep["metrics"][repr(best)]}
    assert "bg_bias_sweep" not in report


def test_decode_knobs_of_the_other_family_are_named_errors(run):
    cfg, work, test_c, _ = run
    with pytest.raises(ValueError, match="grid models only"):
        evaluate_model(cfg, test_c, work, bg_bias=1.0, device="cpu")
    with pytest.raises(ValueError, match="grid models only"):
        evaluate_model(cfg, test_c, work, bg_bias_sweep=[0.0], device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        evaluate_model(cfg, test_c, work, accdoa_threshold=-0.1, device="cpu")
    with pytest.raises(ValueError, match="at least one threshold"):
        evaluate_model(cfg, test_c, work, accdoa_threshold_sweep=[], device="cpu")
    grid_only = pc.parse_overrides(cfg, ["targets.accdoa=false"])
    plain = synthetic_corpus(grid_only, n_files=1, seconds=1.0, seed=1, train=False,
                             device="cpu")
    with pytest.raises(ValueError, match="targets.accdoa=true"):
        evaluate_model(cfg, plain, work, device="cpu")


def test_accdoa_under_a_mesh_of_several_ranks_names_its_roadmap_item(monkeypatch):
    from seld_tpu_torch.train.trainer import check_mesh_config

    cfg = pc.parse_overrides(pc.Config(), ["model.model_type=accdoa_conformer"])
    check_mesh_config(cfg, 250)  # one rank: allowed
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        check_mesh_config(cfg, 250)
    check_mesh_config(pc.parse_overrides(cfg, ["mesh.enable=off"]), 250)
