"""The port's ACS test-time augmentation (seld_tpu_torch/tta.py,
SELDPredictor.tta, evaluate_model(tta_transforms=...)) against seld_tpu's,
on the CPU at tiny widths: the same refusals word for word;
make_tta_forward on converted weights for the three output kinds, with
both sweeps and folds 1 and 2 (averages within 1e-5, votes equal); the
identity transform bit-equal to the plain decode; the group's
equivariance; evaluate_model's TTA decodes against the JAX package's
decodes and metrics of the port's averages; a predictor's TTA predictions
against the JAX predictor's on the same weights. Every test removes what
it writes."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu import accdoa as ja
from seld_tpu import tta as jax_tta
from seld_tpu.config import Config, WindowConfig, config_to_dict, parse_overrides
from seld_tpu.eval import metrics as jax_metrics
from seld_tpu.features.acs import acs_tables, audio_channel_transform, vector_tables
from seld_tpu.features.spatial import feature_channels
from seld_tpu.infer import SELDPredictor as JaxPredictor
from seld_tpu.losses.seld_loss import _bit_labels
from seld_tpu.models import build_model
from seld_tpu.train.checkpoint import CheckpointManager
from seld_tpu.train.optimizer import make_optimizer
from seld_tpu.train.state import create_train_state
from seld_tpu_torch import accdoa as pa
from seld_tpu_torch import config as pc
from seld_tpu_torch import tta as port_tta
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.data.corpus import compute_mel_features
from seld_tpu_torch.data.sampler import BatchIterator
from seld_tpu_torch.data.synthetic import synthetic_corpus
from seld_tpu_torch.eval import evaluate_model
from seld_tpu_torch.infer import SELDPredictor
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_backbones import random_variables
from tests.test_torch_eval import _assert_same
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_predict import _assert_same_decisions

TINY = ["model.crnn_cnn_channels=8,16", "model.conf_d_model=16", "model.conf_n_heads=2",
        "model.conf_n_layers=1", "model.compute_dtype=float32", "features.feature_set=mel_iv"]
MODEL_OF = {"grid": "conformer", "accdoa": "accdoa_conformer",
            "multi_accdoa": "multi_accdoa_conformer"}
B, T = 2, 6
SUBSET = (0, 5, 10, 15)  # rotations, a reflection and elevation flips
AVG_ATOL = 1e-5  # float32 probabilities and vectors, sums in another order
BIASES = [0.0, 0.7, 2.0]
THRESHOLDS = [0.3, 0.5, 0.7]


def tiny_overrides(kind):
    return [f"model.model_type={MODEL_OF[kind]}", *TINY]


@pytest.fixture(scope="module")
def models():
    """kind -> (JAX model, its random numpy variables, the port model holding
    them, a (B, T, 7, 64) input)."""
    out = {}
    for i, kind in enumerate(MODEL_OF):
        cfg = parse_overrides(Config(), tiny_overrides(kind))
        model = build_model(cfg.model, cfg.grid)
        variables = random_variables(model, jnp.zeros((B, T, 7, 64), jnp.float32), seed=i)
        pcfg = pc.parse_overrides(pc.Config(), tiny_overrides(kind))
        port = build_port_model(pcfg.model, pcfg.grid, device="cpu", seed=None, in_channels=7)
        port.load_state_dict(state_dict_from_jax(variables, pcfg.model))
        mel = np.random.default_rng(10 + i).standard_normal((B, T, 7, 64)).astype(np.float32)
        out[kind] = (model, variables, port, mel)
    return out


def _jax_fwd(model, **kw):
    return jax.jit(jax_tta.make_tta_forward(lambda v, m: model.apply(v, m, train=False),
                                            18, 36, "mel_iv", **kw))


def _port_fwd(port, **kw):
    fwd = port_tta.make_tta_forward(port, 18, 36, "mel_iv", **kw)
    return lambda mel: fwd(torch.from_numpy(mel)).numpy()


# --- validation and refusals ---------------------------------------------------


@pytest.mark.parametrize("transforms", [None, [3, 0], (), (1, 1), (16,), (-1, 2)])
def test_validate_transforms_as_jax(transforms):
    try:
        want = jax_tta.validate_transforms(transforms)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_tta.validate_transforms(transforms)
        assert str(got.value) == str(e)
    else:
        assert port_tta.validate_transforms(transforms) == want


@pytest.mark.parametrize("kw", [
    dict(kind="other"),
    dict(kind="accdoa", bias_sweep=[0.0]),
    dict(kind="grid", threshold_sweep=[0.5]),
    dict(kind="multi_accdoa", bias_sweep=[0.0]),
    dict(kind="grid", fold=0),
    dict(kind="grid", transforms=(0, 1, 2), fold=2),
    dict(kind="grid", fold=2, bias_sweep=[0.0, 1.0]),
    dict(kind="multi_accdoa", fold=4, threshold_sweep=[0.5]),
    dict(kind="grid", feature_set="mel"),
    dict(kind="grid", feature_set="mel_gcc"),
])
def test_refusals_are_jax_refusals_word_for_word(kw):
    kw = {"feature_set": "mel_iv", **kw}
    with pytest.raises(ValueError) as want:
        jax_tta.make_tta_forward(lambda v, m: m, 18, 36, **kw)
    with pytest.raises(ValueError) as got:
        port_tta.make_tta_forward(lambda m: m, 18, 36, **kw)
    assert str(got.value) == str(want.value)


# --- make_tta_forward against JAX's --------------------------------------------

VARIANTS = [("grid", {}), ("grid", {"fold": 2}), ("grid", {"bias_sweep": BIASES}),
            ("accdoa", {}), ("accdoa", {"fold": 2}),
            ("multi_accdoa", {}), ("multi_accdoa", {"fold": 4}),
            ("multi_accdoa", {"threshold_sweep": THRESHOLDS}),
            ("multi_accdoa", {"transforms": SUBSET, "activity_threshold": 0.35})]


@pytest.mark.parametrize("kind,kw", VARIANTS,
                         ids=[f"{k}-{'-'.join(map(str, v)) or 'plain'}" for k, v in VARIANTS])
def test_tta_forward_matches_jax(models, kind, kw):
    model, variables, port, mel = models[kind]
    want = np.asarray(_jax_fwd(model, kind=kind, **kw)(variables, jnp.asarray(mel)))
    got = _port_fwd(port, kind=kind, **kw)(mel)
    assert got.shape == want.shape and got.dtype == np.float32
    if kind == "multi_accdoa":  # sums of {0, 1} maps
        np.testing.assert_array_equal(got, want)
        assert 0 < got.max() <= 1.0
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=AVG_ATOL)
    if "fold" in kw:  # a folded forward against fold 1 of the port itself
        np.testing.assert_allclose(got, _port_fwd(port, kind=kind)(mel), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", sorted(MODEL_OF))
def test_identity_tta_is_bit_equal_to_the_plain_decode(models, kind):
    _, _, port, mel = models[kind]
    x = torch.from_numpy(mel)
    with torch.no_grad():
        out = port(x)
        avg = port_tta.make_tta_forward(port, 18, 36, "mel_iv", transforms=(0,), kind=kind)(x)
    if kind == "grid":
        plain, tta = torch.argmax(out, dim=2), torch.argmax(avg, dim=2)
    elif kind == "accdoa":
        plain, tta = (pa.decode_accdoa_to_grid(v, 18, 36, 14, 0.5) for v in (out, avg))
        assert torch.equal(avg, out)
    else:
        plain = pa.decode_multi_accdoa_to_grid(out, 18, 36, 14, 0.5)
        tta = pa.decode_vote_grid(avg, 14)
    assert torch.equal(tta, plain)
    assert (plain != 13).any() if kind != "grid" else plain.unique().numel() > 1


@pytest.mark.parametrize("kind", sorted(MODEL_OF))
@pytest.mark.parametrize("s", [3, 6, 13])
def test_group_average_is_equivariant(models, kind, s):
    """The full-group average of a transformed scene is the label-side
    transform of the original scene's average: the same 16 views, summed
    in another order (votes bit for bit)."""
    _, _, port, mel = models[kind]
    fwd = _port_fwd(port, kind=kind)
    cell_gather, ch_perm, ch_sign = acs_tables(18, 36, "mel_iv")
    mel_s = mel[:, :, ch_perm[s]] * ch_sign[s][None, None, :, None]
    got, base = fwd(mel_s.astype(np.float32)), fwd(mel)
    if kind == "accdoa":
        vperm, vsign = vector_tables("mel_iv")
        np.testing.assert_allclose(got, base[..., vperm[s]] * vsign[s], rtol=0, atol=1e-6)
    elif kind == "grid":
        np.testing.assert_allclose(got, base[..., cell_gather[s]], rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, base[..., cell_gather[s]])


# --- evaluate_model under TTA --------------------------------------------------


@pytest.fixture(scope="module", params=sorted(MODEL_OF))
def eval_run(request, tmp_path_factory, models):
    """(kind, cfg, checkpoint tree, test corpus, port model) of a tiny model
    on mel_iv, its converted weights saved as the tree's best checkpoint."""
    kind = request.param
    base = tmp_path_factory.mktemp(f"tta_eval_{kind}")
    over = [*tiny_overrides(kind), "window.window_seconds=0.2", "window.hop_seconds=0.2",
            "train.batch_size=4", f"data.base_path={base}"]
    if kind != "grid":
        over += ["targets.accdoa=true"] + (["targets.accdoa_tracks=3"]
                                           if kind == "multi_accdoa" else [])
    cfg = pc.parse_overrides(pc.Config(), over)
    port = models[kind][2]
    work = base / "checkpoints"
    save_checkpoint(work / "best" / "epoch_0001.pt", port, cfg, 1,
                    meta={"epoch": 1, "train_loss": 0.0, "test_loss": 0.0})
    test_c = synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=1, train=False,
                              event_rate_hz=3.0, device="cpu")
    yield kind, cfg, work, test_c, port
    shutil.rmtree(base, ignore_errors=True)


def test_evaluate_model_under_tta_is_jax_decodes_of_the_port_averages(eval_run):
    """Every metric and sweep row of the TTA report equals the JAX package's
    decode and metrics of the port's TTA averages; the loss is the plain
    forward's."""
    kind, cfg, work, test_c, port = eval_run
    # the untrained single-ACCDOA model's views disagree, so its mean
    # vectors are short: thresholds below the default make cells active
    sweep_kw = {"grid": {"bg_bias_sweep": BIASES},
                "accdoa": {"accdoa_threshold_sweep": [0.01, 0.03, 0.5]},
                "multi_accdoa": {"accdoa_threshold_sweep": THRESHOLDS}}[kind]
    knob = {"grid": {"bg_bias": 0.5}, "accdoa": {"accdoa_threshold": 0.02},
            "multi_accdoa": {"accdoa_threshold": 0.4}}[kind]
    report = evaluate_model(cfg, test_c, work, tta_transforms=SUBSET, device="cpu",
                            save_visualizations=False, **sweep_kw, **knob)
    plain = evaluate_model(cfg, test_c, work, device="cpu", save_visualizations=False)
    assert report["test_loss"] == plain["test_loss"]

    main_value = next(iter(knob.values()))
    values = next(iter(sweep_kw.values()))
    preds, trues, swept = [], [], {v: [] for v in values}

    def decode(avg, v):
        if kind == "grid":
            return np.asarray(jnp.argmax(avg, axis=2)).astype(np.int8)
        if kind == "multi_accdoa":
            return np.asarray(ja.decode_vote_grid_jnp(avg, 14))
        return np.asarray(ja.decode_accdoa_to_grid_jnp(avg, 18, 36, 14, v))

    for batch in BatchIterator(test_c, cfg.train.batch_size, shuffle=False, prefetch=0):
        mel, n = torch.from_numpy(batch.mel), batch.n_valid
        with torch.no_grad():
            if kind == "grid":
                avgs = port_tta.make_tta_forward(port, 18, 36, "mel_iv", SUBSET,
                                                 bias_sweep=[*values, main_value])(mel)
                per_value = dict(zip([*values, "main"], avgs.numpy()))
            elif kind == "multi_accdoa":
                avgs = port_tta.make_tta_forward(port, 18, 36, "mel_iv", SUBSET, kind=kind,
                                                 threshold_sweep=[*values, main_value])(mel)
                per_value = dict(zip([*values, "main"], avgs.numpy()))
            else:
                avg = port_tta.make_tta_forward(port, 18, 36, "mel_iv", SUBSET,
                                                kind=kind)(mel).numpy()
                per_value = {v: avg for v in [*values, "main"]}
        preds.append(decode(per_value["main"], main_value)[:n])
        for v in values:
            swept[v].append(decode(per_value[v], v)[:n])
        trues.append(np.asarray(_bit_labels(jnp.asarray(batch.label_mask), 14)).astype(
            np.int8)[:n])
    pred, true = np.concatenate(preds), np.concatenate(trues)
    assert (pred != 13).any(), np.abs(per_value['main']).max()
    _assert_same(report["dcase2022"], jax_metrics.dcase2022_metrics(pred, true, 18, 36, 14))
    _assert_same(report["dcase"], jax_metrics.seld_metrics(pred, true, 18, 36, 14))
    name = "bg_bias" if kind == "grid" else "accdoa_threshold"
    rows = report[f"{name}_sweep"]["metrics"]
    assert list(rows) == [repr(v) for v in values]
    for v in values:
        want = jax_metrics.dcase2022_metrics(np.concatenate(swept[v]), true, 18, 36, 14)
        _assert_same(rows[repr(v)], {k: float(want[k]) for k in rows[repr(v)]})


# --- the predictor against JAX's -----------------------------------------------

BATCH = 2


def jax_and_port_checkpoints(tmp, overrides, batch=BATCH, seed=5):
    """A JAX checkpoint tree (tmp/ckpt) and a port checkpoint (tmp/port.pt)
    of the same random weights, 0.2 s windows."""
    cfg = dataclasses.replace(parse_overrides(Config(), overrides),
                              window=WindowConfig(window_seconds=0.2, hop_seconds=0.2))
    model = build_model(cfg.model, cfg.grid)
    win = cfg.window.window_frames(cfg.features)
    x0 = np.zeros((batch, win, feature_channels(cfg.features.feature_set), 64), np.float32)
    state = create_train_state(model, make_optimizer(cfg.train.learning_rate),
                               jax.random.PRNGKey(0), x0)
    variables = random_variables(model, jnp.asarray(x0), seed=seed)
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    mgr = CheckpointManager(tmp / "ckpt", cfg)
    mgr.save_best(1, state, 0.0, 0.0)
    mgr.wait()
    mgr.close()
    port_cfg = pc.config_from_dict(config_to_dict(cfg))
    save_checkpoint(tmp / "port.pt", state_dict_from_jax(variables, port_cfg.model), port_cfg)
    return tmp / "ckpt", tmp / "port.pt"


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """(JAX predictor, port checkpoint) of a tiny mel_iv Conformer serving
    the same random weights."""
    tmp = tmp_path_factory.mktemp("tta_predict")
    ckpt, port = jax_and_port_checkpoints(tmp, tiny_overrides("grid"))
    yield JaxPredictor(ckpt, batch_windows=BATCH), port
    shutil.rmtree(tmp, ignore_errors=True)


def _clip(seconds, seed=7):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((4, int(seconds * 24_000)))).astype(np.float32)


def test_predictor_tta_matches_jax(predictors):
    jax_pred, port_path = predictors
    wave = _clip(1.3)
    jax_pred.tta(SUBSET)
    want = jax_pred.predict_waveform(wave)
    port = SELDPredictor(port_path, batch_windows=BATCH, device="cpu").tta(SUBSET)
    got = port.predict_waveform(wave)
    mel = compute_mel_features(wave, port.cfg.features, device="cpu")
    t, win = mel.shape[0], port.win
    n = -(-t // win)
    mel = torch.cat([mel, mel.new_zeros((n * win - t, *mel.shape[1:]))])
    avg = torch.cat(list(port._batched(mel.reshape(n, win, *mel.shape[1:]),
                                       port._forward_probs))).float()
    top = torch.topk(avg.reshape(n * win, *avg.shape[2:])[:t], 2, dim=1).values
    margin = (top[:, 0] - top[:, 1]).numpy()
    _assert_same_decisions(want.classes, got.classes, margin)
    assert got.classes.shape == (t, 648) and len(np.unique(got.classes)) > 1
    assert port._tta_transforms == SUBSET and port._tta_fold == 1


def test_predictor_tta_refuses_plain_mel(tmp_path):
    cfg = pc.parse_overrides(pc.Config(), [*TINY[:-1], "model.model_type=conformer"])
    model = build_port_model(cfg.model, cfg.grid, device="cpu", seed=0)
    save_checkpoint(tmp_path / "mel.pt", model, cfg)
    with pytest.raises(ValueError, match="mel_iv"):
        SELDPredictor(tmp_path / "mel.pt", device="cpu").tta()


@pytest.mark.parametrize("s", [2, 9])
def test_predictor_tta_of_a_transformed_scene(predictors, s):
    """Full-group TTA probabilities of the scene transformed on the audio
    side equal the label-side transform of the original's, within the
    float16 representation and the features' rounding."""
    _, port_path = predictors
    port = SELDPredictor(port_path, batch_windows=BATCH, device="cpu").tta()
    wave = _clip(0.6, seed=s)
    perm, sign = audio_channel_transform(s)
    wave_s = (sign[:, None] * wave[perm]).astype(np.float32)

    def probs(w):
        mel = compute_mel_features(w, port.cfg.features, device="cpu")
        n = mel.shape[0] // port.win
        windows = mel[:n * port.win].reshape(n, port.win, *mel.shape[1:])
        return torch.cat(list(port._batched(windows, port._forward_probs))).float().numpy()

    cell_gather, _, _ = acs_tables(18, 36, "mel_iv")
    np.testing.assert_allclose(probs(wave_s), probs(wave)[..., cell_gather[s]], atol=2e-3)
