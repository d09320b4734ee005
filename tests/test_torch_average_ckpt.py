"""Checkpoint averaging (SWA, seld_tpu_torch/tools/average_ckpt.py) against
seld_tpu's, on the CPU: random JAX variables of three epochs averaged by
the JAX package and converted, against the port's average of the three
converted state_dicts; the selection, what comes from the newest source,
and the errors of the JAX tool; then one tiny `cli train` run on "mel_iv"
with rolling checkpoints through `average-ckpts`, `predict` and `eval` of
the average, `eval --tta`, `calibrate --tta` and `predict --calibration`
(TTA turned on by the file), `predict --stream --tta`. Every test removes
what it writes."""

import contextlib
import io
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import Config, parse_overrides
from seld_tpu.models import build_model
from seld_tpu.tools.average_ckpt import _mean_trees
from seld_tpu_torch import config as pc
from seld_tpu_torch.calibrate import load_calibration
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.data.synthetic import synthetic_raw_files
from seld_tpu_torch.tools.average_ckpt import average_checkpoints, mean_state_dicts
from seld_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_backbones import random_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import printed_json

MODELS = {
    "conformer": ["model.model_type=conformer", "model.crnn_cnn_channels=8,16",
                  "model.conf_d_model=16", "model.conf_n_heads=2", "model.conf_n_layers=1"],
    "crnn": ["model.model_type=crnn", "model.crnn_cnn_channels=8,16",
             "model.crnn_rnn_hidden=16", "model.crnn_rnn_layers=1"],
}


@pytest.fixture(autouse=True)
def remove_what_the_test_wrote(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_average_equals_jax_average_converted(name):
    """JAX's leaf-wise float64 mean of three epochs' variables, converted,
    equals the port's mean of the three converted state_dicts to float32
    rounding (one ulp: numpy and torch sum the float64 means in their own
    orders)."""
    cfg = parse_overrides(Config(), MODELS[name])
    model = build_model(cfg.model, cfg.grid)
    x0 = jnp.zeros((2, 6, 4, 64), jnp.float32)
    epochs = [random_variables(model, x0, seed=s) for s in range(3)]
    pcfg = pc.parse_overrides(pc.Config(), MODELS[name])
    want = state_dict_from_jax(_mean_trees(epochs), pcfg.model)
    got = mean_state_dicts([state_dict_from_jax(v, pcfg.model) for v in epochs])
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.float32, key
        np.testing.assert_array_max_ulp(got[key].numpy(), want[key].numpy(), maxulp=1)
    newest = state_dict_from_jax(epochs[-1], pcfg.model)
    assert any(not torch.equal(got[k], newest[k]) for k in got)


def test_mean_state_dicts_keeps_integer_entries_of_the_newest():
    half = torch.float16
    a = {"w": torch.tensor([1.0, 2.0]), "n": torch.tensor(3), "h": torch.tensor([1.0], dtype=half)}
    b = {"w": torch.tensor([2.0, 5.0]), "n": torch.tensor(7), "h": torch.tensor([2.0], dtype=half)}
    out = mean_state_dicts([a, b])
    assert torch.equal(out["w"], torch.tensor([1.5, 3.5])) and out["n"].item() == 7
    assert out["h"].dtype == torch.float16 and out["h"].item() == 1.5


def _rolling_tree(root, epochs=(1, 2, 3)):
    """A run tree whose rolling checkpoints hold seeded tiny CRNN weights."""
    cfg = pc.parse_overrides(pc.Config(), MODELS["crnn"])
    from seld_tpu_torch.models import build_model as build_port_model

    states = {}
    for e in epochs:
        model = build_port_model(cfg.model, cfg.grid, device="cpu", seed=e)
        states[e] = model.state_dict()
        save_checkpoint(root / "rolling" / f"epoch_{e:04d}.pt", model, cfg, e,
                        {"state": {}, "param_groups": [{"lr": 0.1 * e}]}, 10 * e,
                        {"epoch": e, "train_loss": 1.0 / e, "test_loss": 2.0 / e})
    return cfg, states


def test_selection_newest_source_and_errors(tmp_path):
    cfg, states = _rolling_tree(tmp_path / "run")
    summary = average_checkpoints(tmp_path / "run", tmp_path / "o1", steps=[3, 1], last=2)
    assert summary["steps"] == [1, 3] and summary["epoch"] == 3  # steps win over last
    (out,) = (tmp_path / "o1" / "best").glob("epoch_*.pt")
    assert out.name == "epoch_0003.pt"
    blob = torch.load(out, weights_only=True)
    for key, value in blob["state_dict"].items():
        want = ((states[1][key].double() + states[3][key].double()) / 2).float()
        np.testing.assert_array_max_ulp(value.numpy(), want.numpy(), maxulp=1)
    assert blob["step"] == 30 and blob["epoch"] == 3
    assert blob["optimizer"]["param_groups"][0]["lr"] == pytest.approx(0.3)
    assert blob["meta"] == {"epoch": 3, "train_loss": 1.0 / 3, "test_loss": 2.0 / 3,
                            "swa_sources": [1, 3]}
    assert pc.config_from_dict(blob["config"]) == cfg
    assert summary["n_params"] == sum(v.numel() for v in states[3].values()) - sum(
        v.numel() for k, v in states[3].items() if k.endswith(("running_mean", "running_var")))
    assert average_checkpoints(tmp_path / "run", tmp_path / "o2", last=2)["steps"] == [2, 3]
    assert average_checkpoints(tmp_path / "run", tmp_path / "o3")["steps"] == [1, 2, 3]
    with pytest.raises(ValueError, match=r"rolling steps \[99\] not found; available"):
        average_checkpoints(tmp_path / "run", tmp_path / "o4", steps=[1, 99])
    with pytest.raises(ValueError, match=">= 2"):
        average_checkpoints(tmp_path / "run", tmp_path / "o5", last=1)
    with pytest.raises(FileNotFoundError, match="no checkpoint config"):
        average_checkpoints(tmp_path / "nowhere", tmp_path / "o6")
    shutil.rmtree(tmp_path / "run" / "rolling")
    shutil.copy(out, tmp_path / "run" / "epoch_0003.pt")
    (tmp_path / "run" / "best").mkdir()
    shutil.move(tmp_path / "run" / "epoch_0003.pt", tmp_path / "run" / "best")
    with pytest.raises(FileNotFoundError, match="no rolling checkpoints"):
        average_checkpoints(tmp_path / "run", tmp_path / "o7")


# --- one tiny run through the command line -------------------------------------

RUN = ["model.model_type=conformer", "model.crnn_cnn_channels=8,16", "model.conf_d_model=16",
       "model.conf_n_heads=2", "model.conf_n_layers=1", "model.compute_dtype=float32",
       "window.window_seconds=0.4", "window.hop_seconds=4.0", "train.batch_size=8",
       "train.num_epochs=3", "train.save_every_n_epochs=1", "features.feature_set=mel_iv"]
TRANSFORMS = "0,5,10"


def _json_of(argv):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert port_main(argv) == 0
    return printed_json(printed.getvalue())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A 3-epoch tiny mel_iv Conformer run with a rolling checkpoint each
    epoch, and a seeded WAV clip."""
    base = tmp_path_factory.mktemp("swa_run")
    over = [*RUN, f"data.base_path={base}"]
    assert port_main(["train", "--synthetic", "--device", "cpu", *over]) == 0
    cfg = pc.parse_overrides(pc.Config(), over)
    wavs, _ = synthetic_raw_files(base / "clips", cfg, n_files=1, seconds=3.0, seed=3)
    yield base, over, wavs[0]
    shutil.rmtree(base, ignore_errors=True)


def _predict_csv(base, name, checkpoint, wav, *flags):
    out = base / f"out_{name}"
    assert port_main(["predict", "--checkpoint", str(checkpoint), "--wavs", wav, "--out",
                      str(out), "--device", "cpu", *flags]) == 0
    (csv,) = (out / "predictions").glob("*.csv")
    return csv.read_text()


def test_cli_average_ckpts_serves_through_predict_and_eval(run):
    base, over, wav = run
    rolling = sorted((base / "checkpoints" / "rolling").glob("epoch_*.pt"))
    assert [p.name for p in rolling] == ["epoch_0001.pt", "epoch_0002.pt", "epoch_0003.pt"]
    assert port_main(["average-ckpts", "--checkpoint-dir", str(base / "checkpoints"),
                      "--output-dir", str(base / "swa"), "--last", "2"]) == 0
    (avg,) = (base / "swa" / "best").glob("epoch_*.pt")
    assert torch.load(avg, weights_only=True)["meta"]["swa_sources"] == [2, 3]
    assert _predict_csv(base, "swa", avg, wav) is not None
    report = _json_of(["eval", "--synthetic", "--device", "cpu",
                       "--num-visualizations", "0", *over,
                       "data.checkpoint_dirname=swa"])
    assert report["checkpoint_epoch"] == 3 and np.isfinite(report["test_loss"])
    plain = _json_of(["eval", "--synthetic", "--device", "cpu",
                      "--num-visualizations", "0", *over])
    assert report["test_loss"] != plain["test_loss"]  # another model: the average


def test_cli_tta_eval_calibrate_and_predict(run):
    """eval --tta keeps the plain loss and sweeps the TTA decode; calibrate
    --tta writes a file that turns TTA on in predict, whose CSV equals the
    same knobs and transforms given as flags; --stream under TTA equals
    offline TTA."""
    base, over, wav = run
    work = base / "checkpoints"
    plain = _json_of(["eval", "--synthetic", "--device", "cpu",
                      "--num-visualizations", "0", *over])
    tta = _json_of(["eval", "--synthetic", "--device", "cpu",
                    "--num-visualizations", "0", "--tta-transforms", TRANSFORMS,
                    "--bg-bias-sweep", "0,1", *over])
    assert tta["test_loss"] == plain["test_loss"]
    assert list(tta["bg_bias_sweep"]["metrics"]) == ["0.0", "1.0"]
    calib = _json_of(["calibrate", "--synthetic", "--device", "cpu", "--tta-transforms",
                      TRANSFORMS, "--bg-bias-sweep=-1,0,1", "--median-widths", "1,3",
                      "--out", str(base / "calib.json"), *over])
    assert calib["tta"] is True and calib["tta_transforms"] == [0, 5, 10]
    assert load_calibration(base / "calib.json")["tta_transforms"] == [0, 5, 10]
    applied = _json_of(["eval", "--synthetic", "--device", "cpu",
                        "--num-visualizations", "0", "--calibration",
                        str(base / "calib.json"), *over])
    assert applied["bg_bias"] == calib["bg_bias"]
    assert applied["dcase2022"]["SELD_error"] == pytest.approx(
        calib["val_metrics"]["SELD_error"], abs=1e-12)  # TTA on, as when calibrated
    (best,) = (work / "best").glob("epoch_*.pt")
    by_file = _predict_csv(base, "file", best, wav, "--calibration", str(base / "calib.json"))
    knobs = ["--bg-bias", str(calib["bg_bias"]), "--median-filter", str(calib["median_filter"])]
    by_flags = _predict_csv(base, "flags", best, wav, *knobs, "--tta-transforms", TRANSFORMS)
    assert by_file == by_flags
    streamed = _predict_csv(base, "stream", best, wav, *knobs, "--tta-transforms", TRANSFORMS,
                            "--stream")
    assert streamed == by_flags
