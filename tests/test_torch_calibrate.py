"""CSV scoring and decode calibration of the port against seld_tpu's, on
the CPU: `score_csv_pairs` and `match_csv_dirs` on seeded CSV directories,
calibration files read across the two packages in both directions,
`run_calibration` on a tiny grid run and a tiny ACCDOA run, and a tiny
ACCDOA command-line run, train -> eval --accdoa-threshold-sweep ->
calibrate -> predict --calibration -> score. Every test removes what it
writes."""

import contextlib
import io
import json
import shutil

import numpy as np
import pytest

from seld_tpu import calibrate as jax_calibrate
from seld_tpu.config import Config, parse_overrides
from seld_tpu.eval import score as jax_score
from seld_tpu_torch import calibrate as port_calibrate
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.data.synthetic import synthetic_corpus, synthetic_raw_files
from seld_tpu_torch.eval import score as port_score
from seld_tpu_torch.train.trainer import train_model
from tests.test_torch_eval import _assert_same
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import port_fails, printed_json


@pytest.fixture(autouse=True)
def remove_what_the_test_wrote(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# --- scoring ----------------------------------------------------------------


def _csv_dirs(root, seed, n_files=3):
    """Seeded ground-truth and prediction CSVs of the same names: the
    prediction keeps, moves, relabels or drops each row and adds false
    alarms; one pair is empty on the prediction side."""
    rng = np.random.default_rng(seed)
    gt, pred = root / "gt", root / "pred"
    for d in (gt, pred):
        d.mkdir(parents=True)
    for i in range(n_files):
        n = int(rng.integers(20, 60))
        rows = np.stack([rng.integers(0, 40, n), rng.integers(0, 13, n), rng.integers(0, 2, n),
                         rng.integers(-180, 180, n), rng.integers(-90, 91, n)], axis=1)
        out = rows.copy()
        fate = rng.random(n)
        out[fate < 0.3, 3] = np.clip(out[fate < 0.3, 3] + 15, -180, 179)
        out[(fate >= 0.3) & (fate < 0.4), 1] = rng.integers(0, 13)
        out = out[fate < 0.85]
        alarms = np.stack([rng.integers(0, 45, 5), rng.integers(0, 13, 5), np.zeros(5, int),
                           rng.integers(-180, 180, 5), rng.integers(-90, 91, 5)], axis=1)
        out = np.concatenate([out, alarms]) if i != 1 else out[:0]
        np.savetxt(gt / f"mix{i:03d}.csv", rows, fmt="%d", delimiter=",")
        np.savetxt(pred / f"mix{i:03d}.csv", out.reshape(-1, 5), fmt="%d", delimiter=",")
    return pred, gt


@pytest.mark.parametrize("macro_over", ["all", "gt"])
@pytest.mark.parametrize("seed", [0, 1])
def test_score_csv_pairs_equal_jax(tmp_path, seed, macro_over):
    pred, gt = _csv_dirs(tmp_path, seed)
    pairs = port_score.match_csv_dirs(pred, gt)
    assert pairs == jax_score.match_csv_dirs(pred, gt) and len(pairs) == 3
    got = port_score.score_csv_pairs(pairs, pc.Config(), macro_over=macro_over)
    want = jax_score.score_csv_pairs(pairs, Config(), macro_over=macro_over)
    assert got["n_files"] == 3
    _assert_same(got, want)


def test_match_csv_dirs_refuses_what_jax_refuses(tmp_path):
    pred, gt = _csv_dirs(tmp_path, 2)
    (pred / "mix000.csv").rename(pred / "other.csv")
    for fn in (port_score.match_csv_dirs, jax_score.match_csv_dirs):
        with pytest.raises(FileNotFoundError, match="missing"):
            fn(pred, gt)
    (pred / "other.csv").rename(pred / "mix000.csv")
    (pred / "extra.csv").write_text("")
    with pytest.raises(FileNotFoundError, match="no ground truth"):
        port_score.match_csv_dirs(pred, gt)
    with pytest.raises(FileNotFoundError, match="no ground-truth CSVs"):
        port_score.match_csv_dirs(pred, tmp_path / "none")


# --- calibration files across the packages ---------------------------------


def _calib(knob, model_type, feature_set="mel", **extra):
    return {"calibration_version": 1, "model_type": model_type, "feature_set": feature_set,
            "checkpoint": "run/checkpoints", "use_checkpoint": "best", "tta": False,
            "tta_transforms": None, "int8": False, "int8_weight_only": False, **knob,
            "median_filter": 3, "val_metrics": {"SELD_error": 0.5}, **extra}


@pytest.mark.parametrize("knob,model_type,feature_set", [
    ({"bg_bias": 1.5}, "resnet_conformer", "mel"),
    ({"accdoa_threshold": 0.4}, "accdoa_conformer", "mel_iv"),
    ({"accdoa_threshold": 0.3}, "multi_accdoa_conformer", "mel"),
])
def test_calibration_files_round_trip_between_the_packages(tmp_path, knob, model_type,
                                                           feature_set, tta=None):
    calib = _calib(knob, model_type, feature_set,
                   **({} if tta is None else {"tta": True, "tta_transforms": tta}))
    over = [f"model.model_type={model_type}", f"features.feature_set={feature_set}"]
    jax_calibrate.write_calibration(calib, tmp_path / "jax.json")
    got = port_calibrate.load_calibration(tmp_path / "jax.json")
    assert got == calib
    port_calibrate.check_calibration_matches(got, pc.parse_overrides(pc.Config(), over))
    port_calibrate.write_calibration(calib, tmp_path / "port.json")
    back = jax_calibrate.load_calibration(tmp_path / "port.json")
    assert back == calib
    jax_calibrate.check_calibration_matches(back, parse_overrides(Config(), over))
    other = pc.parse_overrides(pc.Config(), ["model.model_type=crnn"])
    with pytest.raises(ValueError, match="recalibrate"):
        port_calibrate.check_calibration_matches(got, other)


@pytest.mark.parametrize("knob,model_type,feature_set", [
    ({"bg_bias": 0.5}, "resnet_conformer", "mel_iv"),
    ({"accdoa_threshold": 0.3}, "multi_accdoa_conformer", "mel_iv"),
])
def test_tta_calibration_files_round_trip_between_the_packages(tmp_path, knob, model_type,
                                                               feature_set):
    test_calibration_files_round_trip_between_the_packages(tmp_path, knob, model_type,
                                                           feature_set, tta=[0, 5, 10])


@pytest.mark.parametrize("extra,match", [
    # test-time augmentation and int8 are ported: their files load
    pytest.param({"tta": True, "tta_transforms": [0, 4]}, None, id="extra0-ROADMAP item 8"),
    pytest.param({"int8": True}, None, id="extra1-ROADMAP item 9"),
])
def test_calibration_of_an_unported_decode_path_names_its_roadmap_item(tmp_path, extra, match):
    calib = _calib({"bg_bias": 1.0}, "resnet_conformer", **extra)
    jax_calibrate.write_calibration(calib, tmp_path / "c.json")
    jax_calibrate.load_calibration(tmp_path / "c.json")  # a valid JAX file
    if match is None:
        assert port_calibrate.load_calibration(tmp_path / "c.json") == calib
        return
    with pytest.raises(NotImplementedError, match=match):
        port_calibrate.load_calibration(tmp_path / "c.json")


@pytest.mark.parametrize("edit,match", [
    ({"calibration_version": 2}, "calibration_version"),
    ({"accdoa_threshold": 0.5}, "exactly one"),
])
def test_malformed_calibration_files_are_refused_as_jax_refuses_them(tmp_path, edit, match):
    (tmp_path / "c.json").write_text(json.dumps({**_calib({"bg_bias": 1.0}, "cnn"), **edit}))
    for load in (port_calibrate.load_calibration, jax_calibrate.load_calibration):
        with pytest.raises(ValueError, match=match):
            load(tmp_path / "c.json")
    with pytest.raises(FileNotFoundError):
        port_calibrate.load_calibration(tmp_path / "none.json")


# --- run_calibration on tiny runs --------------------------------------------

RUN = ["model.crnn_cnn_channels=8,16", "model.conf_d_model=16", "model.conf_n_heads=2",
       "model.conf_n_layers=1", "model.compute_dtype=float32", "window.window_seconds=0.4",
       "window.hop_seconds=0.4", "train.batch_size=4", "train.num_epochs=1"]
FAMILIES = {"grid": ["model.model_type=conformer"],
            "accdoa": ["model.model_type=accdoa_conformer", "targets.accdoa=true"]}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def run(request, tmp_path_factory):
    base = tmp_path_factory.mktemp(f"calibrate_{request.param}")
    cfg = pc.parse_overrides(pc.Config(), [*RUN, *FAMILIES[request.param],
                                           f"data.base_path={base}"])
    train_c = synthetic_corpus(cfg, n_files=1, seconds=3.0, seed=0, event_rate_hz=3.0,
                               device="cpu")
    val_c = synthetic_corpus(cfg, n_files=1, seconds=3.0, seed=1, train=False,
                             event_rate_hz=3.0, device="cpu")
    train_model(cfg, train_c, val_c, device="cpu")
    yield request.param, cfg, val_c
    shutil.rmtree(base, ignore_errors=True)


def test_run_calibration_picks_what_its_sweeps_imply(run):
    family, cfg, val_c = run
    knob = "bg_bias" if family == "grid" else "accdoa_threshold"
    values = [0.0, 1.0, 2.0] if family == "grid" else [0.2, 0.4, 0.6]
    grids = {"bias_grid" if family == "grid" else "threshold_grid": values}
    calib = port_calibrate.run_calibration(cfg, val_c, cfg.data.checkpoint_path,
                                           median_widths=[1, 3, 5], device="cpu", **grids)
    sweep, widths = calib["knob_sweep"], calib["median_sweep"]
    assert sweep["knob"] == knob and list(sweep["metrics"]) == [repr(v) for v in values]
    best = min(values, key=lambda v: sweep["metrics"][repr(v)]["SELD_error"])
    assert calib[knob] == best == sweep["best"][knob]
    best_w = min((1, 3, 5), key=lambda w: widths["metrics"][str(w)]["SELD_error"])
    assert calib["median_filter"] == best_w
    assert calib["val_metrics"] == widths["metrics"][str(best_w)]
    # pass 2 ran at the chosen knob: its unfiltered row is pass 1's row there
    assert widths["metrics"]["1"] == sweep["metrics"][repr(best)]
    assert (calib["model_type"], calib["feature_set"]) == (cfg.model.model_type, "mel")
    assert not calib["tta"] and not calib["int8"]
    other = "threshold_grid" if family == "grid" else "bias_grid"
    with pytest.raises(ValueError, match="applies to"):
        port_calibrate.run_calibration(cfg, val_c, cfg.data.checkpoint_path, device="cpu",
                                       **{other: [0.5]})


# --- the command line --------------------------------------------------------

TINY_CLI = ["model.crnn_cnn_channels=8,16", "model.conf_d_model=16", "model.conf_n_heads=2",
            "model.conf_n_layers=1", "model.compute_dtype=float32", "window.window_seconds=0.4",
            "window.hop_seconds=4.0", "train.batch_size=8", "train.num_epochs=1"]
# (overrides, knob, its flag, a sweep, its default, a value that silences every cell,
# the loss term of the report)
CLI = {
    "accdoa": (["model.model_type=accdoa_conformer", "features.feature_set=mel_iv",
                "train.acs_augment=true"], "accdoa_threshold", "--accdoa-threshold",
               (0.3, 0.5), 0.5, "1.8", "accdoa"),  # tanh bounds a norm by sqrt(3)
    "grid": (["model.model_type=conformer"], "bg_bias", "--bg-bias", (0.0, 2.0), 0.0, "-1000",
             "class_mse"),
}


def _json_of(argv):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert port_main(argv) == 0
    return printed_json(printed.getvalue())


@pytest.mark.parametrize("family", sorted(CLI))
def test_cli_train_eval_calibrate_predict_score(tmp_path, family):
    """train (the ACCDOA run on mel_iv, with ACS on its targets) -> eval with
    a sweep of the family's knob -> calibrate -> eval and predict with the
    file, the predict bit-equal to the same knobs given as flags, an
    explicit flag winning over the file -> score of the prediction against
    the clip's ground truth."""
    extra, knob, flag, values, default, silence, term = CLI[family]
    over = [*TINY_CLI, *extra, f"data.base_path={tmp_path}"]
    sweep = ",".join(map(str, values))
    work = tmp_path / "checkpoints"
    assert port_main(["train", "--synthetic", "--device", "cpu", *over]) == 0
    report = _json_of(["eval", "--synthetic", "--device", "cpu",
                       "--num-visualizations", "0", f"{flag}-sweep", sweep,
                       *over])
    assert list(report[f"{knob}_sweep"]["metrics"]) == [repr(v) for v in values]
    assert report[knob] == default and np.isfinite(report[term])
    calib = _json_of(["calibrate", "--synthetic", "--device", "cpu", f"{flag}-sweep", sweep,
                      "--median-widths", "1,3", *over])
    path = work / "decode_calibration.json"
    assert port_calibrate.load_calibration(path)[knob] == calib[knob] in values
    assert calib["model_type"] == over[len(TINY_CLI)].split("=")[1]
    applied = _json_of(["eval", "--synthetic", "--device", "cpu",
                        "--num-visualizations", "0", "--calibration", str(path),
                        *over])
    assert applied[knob] == calib[knob] and applied["median_filter"] == calib["median_filter"]

    cfg = pc.parse_overrides(pc.Config(), over)
    wavs, csvs = synthetic_raw_files(tmp_path / "clips", cfg, n_files=1, seconds=6.0, seed=3)
    (best,) = (work / "best").glob("epoch_*.pt")
    outs = {}
    for name, flags in (("file", ["--calibration", str(path)]),
                        ("flags", [flag, str(calib[knob]),
                                   "--median-filter", str(calib["median_filter"])]),
                        ("wins", ["--calibration", str(path), flag, silence])):
        assert port_main(["predict", "--checkpoint", str(best), "--wavs", wavs[0], "--out",
                          str(tmp_path / name), "--device", "cpu", *flags]) == 0
        (csv,) = (tmp_path / name / "predictions").glob("*.csv")
        outs[name] = csv.read_bytes()
    assert outs["file"] == outs["flags"]
    assert outs["file"] and not outs["wins"]
    gt = tmp_path / "gt"
    gt.mkdir()
    shutil.copy(csvs[0], gt)  # clip000.csv, the name of the clip's prediction
    pred_dir = tmp_path / "file" / "predictions"
    scored = _json_of(["score", "--pred-dir", str(pred_dir), "--gt-dir", str(gt)])
    want = jax_score.score_csv_pairs(jax_score.match_csv_dirs(pred_dir, gt), Config())
    assert scored["n_files"] == 1
    _assert_same(scored, json.loads(json.dumps(want)))
    # a file made for another model is refused before anything runs
    (tmp_path / "other.json").write_text(json.dumps(
        {**json.loads(path.read_text()), "model_type": "multi_accdoa_conformer"}))
    port_fails(["predict", "--checkpoint", str(best), "--wavs", wavs[0], "--out",
               str(tmp_path / "x"), "--device", "cpu", "--calibration",
               str(tmp_path / "other.json")], ValueError, "recalibrate")


def test_predict_calibration_of_a_tta_file_turns_tta_on(tmp_path):
    """A file tuned under TTA serves under TTA with its transforms: the CSV
    equals the same knobs and transforms given as flags; an explicit
    --tta-transforms wins over the file's."""
    from seld_tpu_torch.data.audio import write_wav
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    cfg = pc.parse_overrides(pc.Config(), [*TINY_CLI, "model.model_type=conformer",
                                           "features.feature_set=mel_iv"])
    model = build_model(cfg.model, cfg.grid, device="cpu", seed=3, in_channels=7)
    save_checkpoint(tmp_path / "m.pt", model, cfg)
    port_calibrate.write_calibration(
        _calib({"bg_bias": 0.25}, "conformer", "mel_iv", tta=True, tta_transforms=[0, 6]),
        tmp_path / "c.json")
    wave = (0.2 * np.random.default_rng(4).standard_normal((4, 36_000))).astype(np.float32)
    write_wav(tmp_path / "x.wav", wave, 24_000)
    outs = {}
    for name, flags in (("file", ["--calibration", str(tmp_path / "c.json")]),
                        ("flags", ["--bg-bias", "0.25", "--median-filter", "3",
                                   "--tta-transforms", "0,6"]),
                        ("plain", ["--bg-bias", "0.25", "--median-filter", "3"]),
                        ("wins", ["--calibration", str(tmp_path / "c.json"),
                                  "--tta-transforms", "0,6,12"]),
                        ("wins_flags", ["--bg-bias", "0.25", "--median-filter", "3",
                                        "--tta-transforms", "0,6,12"])):
        assert port_main(["predict", "--checkpoint", str(tmp_path / "m.pt"), "--wavs",
                          str(tmp_path / "x.wav"), "--out", str(tmp_path / name), "--device",
                          "cpu", *flags]) == 0
        outs[name] = (tmp_path / name / "predictions" / "x.csv").read_text()
    assert outs["file"] == outs["flags"] != outs["plain"]
    assert outs["wins"] == outs["wins_flags"]
