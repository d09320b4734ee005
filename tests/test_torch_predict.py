"""The serving slice as a whole: a seld_tpu checkpoint, carried across with
state_dict_from_jax, served by seld_tpu_torch.infer.SELDPredictor on the
CPU, against seld_tpu.infer.SELDPredictor on the same clip."""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from seld_tpu.config import Config, ModelConfig, WindowConfig, config_to_dict
from seld_tpu.data.audio import write_wav
from seld_tpu.infer import Prediction as JaxPrediction
from seld_tpu.infer import SELDPredictor as JaxPredictor
from seld_tpu.models import build_model
from seld_tpu.train.checkpoint import CheckpointManager
from seld_tpu.train.optimizer import make_optimizer
from seld_tpu.train.state import create_train_state
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.config import config_from_dict
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.data.corpus import compute_mel_features
from seld_tpu_torch.infer import Prediction, SELDPredictor
from seld_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

SR = 24_000
BATCH = 4
# argmax decisions may differ only where the two float32 forwards' ~1e-5
# logit (or probability) noise can reorder the two best classes
MARGIN = 1e-3


def _randomize(variables, seed=0):
    """Random norm scales, biases and BatchNorm statistics, so that the
    decoded grid holds many classes rather than one."""
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
        return x

    return jax.tree_util.tree_map_with_path(visit, variables)


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    """(JAX predictor, port predictor, tmp dir) serving the same weights."""
    tmp = tmp_path_factory.mktemp("torch_predict")
    cfg = dataclasses.replace(
        Config(),
        model=ModelConfig(resnet_conf_d_model=64, resnet_conf_n_heads=4,
                          resnet_conf_n_layers=1, compute_dtype="float32"),
        window=WindowConfig(window_seconds=0.2, hop_seconds=0.2),
    )
    model = build_model(cfg.model, cfg.grid)
    win = cfg.window.window_frames(cfg.features)
    state = create_train_state(
        model, make_optimizer(cfg.train.learning_rate), jax.random.PRNGKey(0),
        np.zeros((BATCH, win, 4, 64), np.float32),
    )
    randomized = _randomize(state.variables())
    state = state.replace(params=randomized["params"],
                          batch_stats=randomized["batch_stats"])
    mgr = CheckpointManager(tmp / "ckpt", cfg)
    mgr.save_best(3, state, 0.0, 0.0)
    mgr.wait()
    mgr.close()
    jax_pred = JaxPredictor(tmp / "ckpt", batch_windows=BATCH)

    # the carry-over path: restored JAX variables -> port checkpoint
    port_cfg = config_from_dict(config_to_dict(cfg))
    variables = jax.tree.map(np.asarray, jax_pred.state.variables())
    save_checkpoint(tmp / "port.pt", state_dict_from_jax(variables, port_cfg.model),
                    port_cfg, epoch=jax_pred.meta["epoch"])
    port_pred = SELDPredictor(tmp / "port.pt", batch_windows=BATCH, device="cpu")
    yield jax_pred, port_pred, tmp
    # the suite's temporary trees share one disk; this module's holds 0.25 GB
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def wave():
    rng = np.random.default_rng(7)
    return (0.1 * rng.standard_normal((4, 3 * SR // 2))).astype(np.float32)


def _top2_margin(scores):
    """(T, M, G) -> (T, G) gap between the two best classes."""
    top = torch.topk(scores, 2, dim=1).values
    return (top[:, 0] - top[:, 1]).numpy()


def _assert_same_decisions(jax_classes, port_classes, margin):
    assert jax_classes.shape == port_classes.shape
    differ = jax_classes != port_classes
    assert not (differ & (margin > MARGIN)).any(), (
        f"{int((differ & (margin > MARGIN)).sum())} cells differ outside the "
        f"{MARGIN} margin band"
    )


def test_predict_matches_jax_no_overlap(predictors, wave):
    jax_pred, port_pred, _ = predictors
    want = jax_pred.predict_waveform(wave, overlap=0.0)
    got = port_pred.predict_waveform(wave, overlap=0.0)
    assert got.classes.shape == (1 + wave.shape[1] // 480, 648)
    assert got.classes.dtype == np.int8

    mel = compute_mel_features(wave, port_pred.cfg.features, device="cpu")
    t, win = mel.shape[0], port_pred.win
    n = -(-t // win)
    mel = torch.cat([mel, mel.new_zeros((n * win - t, *mel.shape[1:]))])
    logits = port_pred._raw_apply(mel.reshape(n, win, *mel.shape[1:]))
    margin = _top2_margin(logits.reshape(n * win, *logits.shape[2:])[:t])
    _assert_same_decisions(want.classes, got.classes, margin)

    rows = got.to_metadata_rows()
    assert len(rows) > 0
    np.testing.assert_array_equal(rows, want.to_metadata_rows())
    assert got.events() == want.events()


@pytest.mark.parametrize("min_votes", [1, 2, 3, 5])
def test_metadata_rows_equal_jax_s(min_votes):
    """The vote over each metadata frame's 5 label frames, row for row and
    in JAX's order, on grids sparse and dense, with the background class
    in between and a ragged tail of frames that no metadata frame takes."""
    rng = np.random.default_rng(min_votes)
    for active in (0.0, 0.05, 0.6, 1.0):
        base = rng.integers(0, 13, (1, 648))
        classes = np.where(rng.random((203, 648)) < 0.3, rng.integers(0, 13, (203, 648)), base)
        classes = np.where(rng.random((203, 648)) < active, classes, 13).astype(np.int8)
        got = Prediction(classes, 18, 36, 14).to_metadata_rows(min_votes)
        want = JaxPrediction(classes, 18, 36, 14).to_metadata_rows(min_votes)
        assert got.dtype == want.dtype == np.int64 and got.shape[1] == 5
        np.testing.assert_array_equal(got, want)
    assert len(got) > 0


def test_predict_matches_jax_overlap(predictors, wave):
    jax_pred, port_pred, _ = predictors
    want = jax_pred.predict_waveform(wave, overlap=0.5)
    got = port_pred.predict_waveform(wave, overlap=0.5)
    mel = compute_mel_features(wave, port_pred.cfg.features, device="cpu")
    margin = _top2_margin(port_pred._average_probs(mel, 0.5))
    _assert_same_decisions(want.classes, got.classes, margin)
    np.testing.assert_array_equal(got.to_metadata_rows(), want.to_metadata_rows())


def test_cli_predict_writes_the_jax_csv(predictors, wave):
    jax_pred, _, tmp = predictors
    wav = tmp / "clip.wav"
    write_wav(wav, wave, SR)
    jax_pred.predict_file(wav, csv_out=tmp / "jax.csv")
    assert port_main([
        "predict", "--checkpoint", str(tmp / "port.pt"), "--wavs", str(wav),
        "--out", str(tmp / "out"), "--device", "cpu",
    ]) == 0
    got = (tmp / "out" / "predictions" / "clip.csv").read_text()
    assert got and got == (tmp / "jax.csv").read_text()


def test_predict_bias_and_median_filter_match_jax(predictors, wave):
    _, _, tmp = predictors
    knobs = dict(batch_windows=BATCH, bg_bias=0.3, median_filter=3)
    want = JaxPredictor(tmp / "ckpt", **knobs).predict_waveform(wave)
    port_pred = SELDPredictor(tmp / "port.pt", device="cpu", **knobs)
    got = port_pred.predict_waveform(wave)

    mel = compute_mel_features(wave, port_pred.cfg.features, device="cpu")
    t, win = mel.shape[0], port_pred.win
    n = -(-t // win)
    mel = torch.cat([mel, mel.new_zeros((n * win - t, *mel.shape[1:]))])
    logits = port_pred._raw_apply(mel.reshape(n, win, *mel.shape[1:]))  # biased
    low = _top2_margin(logits.reshape(n * win, *logits.shape[2:])[:t]) <= MARGIN
    # a width-3 filter spreads a low-margin decision to its two neighbours
    near_low = low.copy()
    near_low[1:] |= low[:-1]
    near_low[:-1] |= low[1:]
    assert not ((want.classes != got.classes) & ~near_low).any()
    assert (got.classes != 13).any() and (got.classes == 13).any()
