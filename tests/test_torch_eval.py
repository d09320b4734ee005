"""The port's evaluation against seld_tpu's, on the CPU: the metrics on the
same class grids (every number equal), the completion marker, and
`evaluate_model`, checkpoint selection on a validation metric and the
`eval`, `train --eval-after` and `verify` subcommands on a tiny run that the
port trains, with the JAX package's eval forward, loss and metrics on the
same weights and corpus as the reference. Every test removes what it
writes: even the smallest flagship's checkpoint is 0.3 GB."""

import contextlib
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seld_tpu.config import GridConfig, LossConfig, ModelConfig
from seld_tpu.eval import metrics as jax_metrics
from seld_tpu.infer import bias_background_logits
from seld_tpu.losses import SELDLossFn
from seld_tpu.losses.seld_loss import _bit_labels
from seld_tpu.models import build_model
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.convert import _resnet_conformer_layers, state_dict_from_jax
from seld_tpu_torch.data.sampler import BatchIterator, place_batch
from seld_tpu_torch.data.synthetic import synthetic_corpus
from seld_tpu_torch.eval import evaluate_model
from seld_tpu_torch.eval import metrics as port_metrics
from seld_tpu_torch.losses import SELDLossFn as PortLossFn
from seld_tpu_torch.models import build_model as build_port_model
from seld_tpu_torch.postprocess import smooth_classes
from seld_tpu_torch.train import completion
from seld_tpu_torch.train.checkpoint import CheckpointManager, checkpoint_file
from seld_tpu_torch.train.steps import make_metric_eval_step
from seld_tpu_torch.train.trainer import train_model
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_cli_helpers import port_fails, printed_json, printed_lines

# --- metrics: the same grids through both packages ------------------------

N_EL, N_AZ, NUM_CLASSES = 18, 36, 14
BG = NUM_CLASSES - 1


def _grids(seed, absent=(), n=3, t=60):
    """Random (true, pred) class grids: sparse events; the prediction moves
    some to a neighbouring cell, relabels some, drops some and adds false
    alarms, so every branch of the metrics runs (several sources of a
    class in a frame included). `absent` classes never occur in the truth."""
    rng = np.random.default_rng(seed)
    g = N_EL * N_AZ
    classes = np.array([c for c in range(BG) if c not in absent])
    true = np.full((n, t, g), BG, np.int8)
    active = rng.random((n, t, g)) < 0.004
    true[active] = rng.choice(classes, int(active.sum()))
    pred = np.full_like(true, BG)
    for w, f, c in zip(*np.nonzero(true != BG)):
        fate = rng.random()
        if fate < 0.5:
            pred[w, f, c] = true[w, f, c]
        elif fate < 0.7:  # a neighbour in azimuth: 10 degrees off
            pred[w, f, (c + 1) % g] = true[w, f, c]
        elif fate < 0.8:  # far off: a spatial false positive
            pred[w, f, (c + 7 * N_AZ + 9) % g] = true[w, f, c]
        elif fate < 0.9:
            pred[w, f, c] = rng.integers(0, BG)
    alarms = rng.random((n, t, g)) < 0.001
    pred[alarms] = rng.integers(0, BG, int(alarms.sum()))
    return true, pred


def _assert_same(got, want, path="report"):
    """Every number of a nested report equal: ints exactly, floats to 1e-12."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= 1e-12, (path, got, want)
    else:
        assert got == want, path


CASES = [(0, ()), (1, ()), (2, (3, 7)), (3, tuple(range(1, BG)))]


@pytest.mark.parametrize("seed,absent", CASES)
def test_accuracy_metrics_equal_jax(seed, absent):
    true, pred = _grids(seed, absent)
    _assert_same(port_metrics.accuracy_metrics(pred, true, BG),
                 jax_metrics.accuracy_metrics(pred, true, BG))


@pytest.mark.parametrize("seed,absent", CASES)
def test_seld_metrics_equal_jax(seed, absent):
    true, pred = _grids(seed, absent)
    _assert_same(port_metrics.seld_metrics(pred, true, N_EL, N_AZ, NUM_CLASSES),
                 jax_metrics.seld_metrics(pred, true, N_EL, N_AZ, NUM_CLASSES))


@pytest.mark.parametrize("macro_over", ["all", "gt"])
@pytest.mark.parametrize("seed,absent", CASES)
def test_dcase2022_metrics_equal_jax(seed, absent, macro_over):
    true, pred = _grids(seed, absent)
    got = port_metrics.dcase2022_metrics(pred, true, N_EL, N_AZ, NUM_CLASSES,
                                         macro_over=macro_over)
    want = jax_metrics.dcase2022_metrics(pred, true, N_EL, N_AZ, NUM_CLASSES,
                                         macro_over=macro_over)
    _assert_same(got, want)
    if absent:  # classes absent from the ground truth are still averaged over
        assert all(got["classwise"]["Nref"][c] == 0 for c in absent)
        assert got["F_macro"] <= got["macro_gt"]["F"]


def test_dcase2022_metrics_on_bitmasks_and_bad_option_equal_jax():
    rng = np.random.default_rng(4)
    shape = (2, 50, N_EL * N_AZ)
    true = np.where(rng.random(shape) < 0.003, rng.integers(1, 2 ** BG, shape), 0).astype(np.uint16)
    pred = np.where(rng.random(shape) < 0.5, true, 0).astype(np.uint16)
    _assert_same(
        port_metrics.dcase2022_metrics(pred, true, N_EL, N_AZ, NUM_CLASSES, bitmask=True),
        jax_metrics.dcase2022_metrics(pred, true, N_EL, N_AZ, NUM_CLASSES, bitmask=True))
    with pytest.raises(ValueError, match="macro_over"):
        port_metrics.dcase2022_metrics(pred, true, macro_over="some")


def test_empty_and_perfect_predictions_equal_jax():
    true, _ = _grids(5)
    for pred in (np.full_like(true, BG), true.copy()):
        for name in ("seld_metrics", "dcase2022_metrics"):
            _assert_same(getattr(port_metrics, name)(pred, true, N_EL, N_AZ, NUM_CLASSES),
                         getattr(jax_metrics, name)(pred, true, N_EL, N_AZ, NUM_CLASSES))
    perfect = port_metrics.dcase2022_metrics(true, true, N_EL, N_AZ, NUM_CLASSES)
    assert perfect["ER"] == 0.0 and perfect["macro_gt"]["F"] == pytest.approx(1.0)


def test_grid_to_frame_doas_equal_jax():
    true, _ = _grids(6)
    got = port_metrics.grid_to_frame_doas(true, N_EL, N_AZ, NUM_CLASSES)
    want = jax_metrics.grid_to_frame_doas(true, N_EL, N_AZ, NUM_CLASSES)
    assert len(got) == len(want) == true.shape[0] * true.shape[1]
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for c in b:
            np.testing.assert_array_equal(a[c], b[c])
    assert port_metrics._hungarian_mean_distance(want[0].get(0, np.zeros((1, 2))), np.array(
        [[5.0, 5.0]])) == jax_metrics._hungarian_mean_distance(
            want[0].get(0, np.zeros((1, 2))), np.array([[5.0, 5.0]]))


# --- completion (the cases of tests/test_completion.py) --------------------


def test_history_predicates():
    assert completion.training_completed({"train_losses": [1.0]})
    assert not completion.training_completed({"preempted_epoch": 2})
    assert not completion.training_completed({"aborted_epoch": 3})
    assert completion.incomplete_reason({"train_losses": []}) is None
    assert completion.incomplete_reason({"preempted_epoch": 2}) == {"preempted_epoch": 2}
    assert completion.incomplete_reason({"aborted_epoch": 3}) == {"aborted_epoch": 3}


def test_workdir_reason_reads_history(tmp_path):
    assert completion.workdir_incomplete_reason(tmp_path) is None  # no history file
    hist = tmp_path / "training_history.json"
    hist.write_text(json.dumps({"train_losses": [1.0], "preempted_epoch": 1}))
    assert completion.workdir_incomplete_reason(tmp_path) == {"preempted_epoch": 1}
    hist.write_text("{ not json")
    assert completion.workdir_incomplete_reason(tmp_path) is None


def test_fake_preempted_train_fn_writes_no_marker(tmp_path):
    def fake_train(cfg, tr, te, workdir, resume=False):
        return None, {"train_losses": [0.5], "preempted_epoch": 1}

    with pytest.raises(completion.IncompleteTrainingError, match="truncated"):
        completion.run_training_stage(None, None, None, tmp_path, train_fn=fake_train)
    assert not (tmp_path / completion.MARKER_NAME).exists()


def test_stale_uncommitted_marker_is_refused(tmp_path):
    (tmp_path / "train_done.json").write_text(json.dumps({"seconds": 80, "params": 123}))
    with pytest.raises(completion.IncompleteTrainingError, match="stale"):
        completion.run_training_stage(None, None, None, tmp_path)


def test_preempted_stage_resumes_then_writes_and_reuses_its_marker(tmp_path):
    """Stage preempted (no marker), the rerun resumes from its checkpoint
    tree and completes, writes the marker, and a third call reuses it."""
    calls = []
    state = type("S", (), {"model": torch.nn.Linear(3, 2)})()

    def fake_train(cfg, tr, te, workdir, resume=False):
        calls.append(resume)
        (workdir / "rolling").mkdir(exist_ok=True)
        if len(calls) == 1:
            return state, {"train_losses": [], "preempted_epoch": 1}
        return state, {"train_losses": [0.5, 0.4]}

    with pytest.raises(completion.IncompleteTrainingError):
        completion.run_training_stage(None, None, None, tmp_path, train_fn=fake_train)
    info = completion.run_training_stage(None, None, None, tmp_path, train_fn=fake_train,
                                         marker_extra={"stage": "a"})
    assert calls == [False, True]
    assert info["completed"] and info["resumed"] and info["epochs"] == 2
    assert info["params"] == 8 and info["stage"] == "a"
    assert json.loads((tmp_path / completion.MARKER_NAME).read_text()) == info
    assert completion.run_training_stage(None, None, None, tmp_path, train_fn=fake_train) == info
    assert calls == [False, True]  # the marker was reused: no third training


# --- a tiny run: evaluate_model, selection on a metric, the CLI -----------

TINY = ["model.resnet_conf_d_model=16", "model.resnet_conf_n_heads=2",
        "model.resnet_conf_n_layers=1", "model.compute_dtype=float32",
        "grid.cell_degrees=30", "window.window_seconds=0.4", "window.hop_seconds=0.4",
        "train.batch_size=4", "train.num_epochs=2", "train.save_every_n_epochs=1",
        "train.select_metric=seld_error"]
MARGIN = 1e-3  # decisions may differ where the two best logits are this close


def _tiny_cfg(base, *extra):
    return pc.parse_overrides(pc.Config(), [*TINY, f"data.base_path={base}", *extra])


@pytest.fixture(autouse=True)
def remove_what_the_test_wrote(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _variables_from_state_dict(state, model_cfg):
    """The port's state_dict as seld_tpu variables: the inverse of
    seld_tpu_torch.convert.state_dict_from_jax, layer kind by layer kind."""
    tree = {"params": {}, "batch_stats": {}}

    def put(collection, path, leaf, value):
        node = tree[collection]
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value)

    for jax_path, name, kind in _resnet_conformer_layers(model_cfg):
        w = state[f"{name}.weight"].numpy()
        if kind == "conv":
            put("params", jax_path, "kernel", w.transpose(2, 3, 1, 0))
            continue
        bias = state[f"{name}.bias"].numpy()
        if kind in ("ln", "bn"):
            put("params", jax_path, "scale", w)
        elif kind == "dense":
            put("params", jax_path, "kernel", w.T)
        elif kind == "depthwise":
            put("params", jax_path, "kernel", w.transpose(2, 1, 0))
        else:  # logits: (M*G, hidden) -> (hidden, M, G)
            m = model_cfg.num_classes
            put("params", jax_path, "kernel", w.T.reshape(w.shape[1], m, -1))
            bias = bias.reshape(m, -1)
        put("params", jax_path, "bias", bias)
        if kind == "bn":
            put("batch_stats", jax_path, "mean", state[f"{name}.running_mean"].numpy())
            put("batch_stats", jax_path, "var", state[f"{name}.running_var"].numpy())
    return tree


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A two-epoch run of the tiny model with the best checkpoint chosen on
    SELD_error: (cfg, workdir, test corpus, history)."""
    base = tmp_path_factory.mktemp("port_eval")
    cfg = _tiny_cfg(base)
    train_c = synthetic_corpus(cfg, n_files=1, seconds=3.0, seed=0, event_rate_hz=3.0,
                               device="cpu")
    test_c = synthetic_corpus(cfg, n_files=1, seconds=3.0, seed=1, train=False,
                              event_rate_hz=3.0, device="cpu")
    _, history = train_model(cfg, train_c, test_c, device="cpu")
    yield cfg, base / "checkpoints", test_c, history
    shutil.rmtree(base, ignore_errors=True)


@pytest.fixture(scope="module")
def report(run):
    cfg, work, test_c, _ = run
    return evaluate_model(cfg, test_c, work, device="cpu", save_visualizations=False)


@pytest.fixture(scope="module")
def port_side(run):
    """(pred grids, true grids, biased-by-2 pred grids, top-2 margins of the
    plain and of the biased logits) of the best checkpoint, by the port."""
    cfg, work, test_c, _ = run
    blob = torch.load(checkpoint_file(work, "best"), weights_only=True)
    model = build_port_model(cfg.model, cfg.grid, device="cpu", seed=None)
    model.load_state_dict(blob["state_dict"])
    step = make_metric_eval_step(model, PortLossFn(cfg.loss, cfg.grid), cfg.grid.num_classes,
                                 bias_sweep=[2.0])
    preds, trues, biased, margins, biased_margins = [], [], [], [], []
    for batch in BatchIterator(test_c, cfg.train.batch_size, shuffle=False, prefetch=0):
        mel, mask, em = place_batch(batch, torch.device("cpu"))
        _, p, t, sw = step(mel, mask, em)
        with torch.no_grad():
            logits = model(mel)
        for store, scores in ((margins, logits), (biased_margins, logits.clone())):
            if store is biased_margins:
                scores[:, :, -1] -= 2.0
            top = torch.topk(scores, 2, dim=2).values
            store.append((top[:, :, 0] - top[:, :, 1])[:batch.n_valid].numpy())
        preds.append(p[:batch.n_valid].numpy())
        trues.append(t[:batch.n_valid].numpy())
        biased.append(sw[0, :batch.n_valid].numpy())
    cat = np.concatenate
    return cat(preds), cat(trues), cat(biased), cat(margins), cat(biased_margins), blob


@pytest.fixture(scope="module")
def jax_side(run, port_side):
    """The JAX package on the same weights and batches: mean loss terms,
    pred and true grids, and pred grids at bg_bias 2."""
    cfg, _, test_c, _ = run
    model_cfg = ModelConfig(resnet_conf_d_model=16, resnet_conf_n_heads=2,
                            resnet_conf_n_layers=1, compute_dtype="float32")
    grid = GridConfig(cell_degrees=30)
    model = build_model(model_cfg, grid)
    variables = _variables_from_state_dict(port_side[5]["state_dict"], cfg.model)
    # the inverse converter is right iff the converter brings its output back
    back = state_dict_from_jax(variables, cfg.model)
    assert all(torch.equal(v, back[k]) for k, v in port_side[5]["state_dict"].items())
    loss_fn = SELDLossFn(LossConfig(), grid)

    @jax.jit
    def step(mel, mask, em):
        logits = model.apply(variables, mel, train=False)
        total, breakdown = loss_fn.from_bitmask(logits, mask, em)
        return ({"loss": total, **breakdown}, jnp.argmax(logits, axis=2).astype(jnp.int8),
                _bit_labels(mask, grid.num_classes).astype(jnp.int8),
                jnp.argmax(bias_background_logits(logits, 2.0), axis=2).astype(jnp.int8))

    losses, preds, trues, biased = [], [], [], []
    for batch in BatchIterator(test_c, cfg.train.batch_size, shuffle=False, prefetch=0):
        em = (np.arange(batch.mel.shape[0]) < batch.n_valid).astype(np.float32)
        m, p, t, pb = step(batch.mel, batch.label_mask, em)
        losses.append({k: float(v) for k, v in m.items()})
        preds.append(np.asarray(p)[:batch.n_valid])
        trues.append(np.asarray(t)[:batch.n_valid])
        biased.append(np.asarray(pb)[:batch.n_valid])
    avg = {k: float(np.mean([m[k] for m in losses])) for k in losses[0]}
    return avg, np.concatenate(preds), np.concatenate(trues), np.concatenate(biased)


def test_report_has_the_jax_package_keys(report, run):
    assert list(report) == [
        "test_loss", "class_mse", "overall_accuracy", "non_bg_accuracy", "active_events",
        "total_cells", "dcase", "dcase2022", "num_frames_with_events", "visualizations",
        "checkpoint_epoch", "checkpoint_kind", "quantized_int8", "bg_bias", "median_filter"]
    assert report["checkpoint_kind"] == "best" and report["visualizations"] == []
    assert report["checkpoint_epoch"] == run[3]["best_val_epoch"]
    assert report["active_events"] > 0 and report["num_frames_with_events"] > 0
    json.dumps(report)  # plain data


def test_evaluate_model_losses_match_jax(report, jax_side):
    """1e-3 on losses of order 0.1: the eval forward's 5e-4 logit tolerance."""
    assert report["test_loss"] == pytest.approx(jax_side[0]["loss"], abs=1e-3)
    assert report["class_mse"] == pytest.approx(jax_side[0]["class_mse"], abs=1e-3)


def test_evaluate_model_grids_and_metrics_match_jax(report, port_side, jax_side, run):
    cfg = run[0]
    pred, true, _, margin, _, _ = port_side
    _, jax_pred, jax_true, _ = jax_side
    np.testing.assert_array_equal(true, jax_true)
    differ = pred != jax_pred
    assert not (differ & (margin > MARGIN)).any()
    # the report is the JAX package's metrics on the port's grids, number for number
    grid = cfg.grid
    _assert_same({k: report[k] for k in ("overall_accuracy", "non_bg_accuracy",
                                         "active_events", "total_cells")},
                 jax_metrics.accuracy_metrics(pred, true, grid.background_class))
    _assert_same(report["dcase"], jax_metrics.seld_metrics(
        pred, true, grid.n_el, grid.n_az, grid.num_classes))
    _assert_same(report["dcase2022"], jax_metrics.dcase2022_metrics(
        pred, true, grid.n_el, grid.n_az, grid.num_classes))
    if not differ.any():
        assert report["overall_accuracy"] == jax_metrics.accuracy_metrics(
            jax_pred, jax_true, grid.background_class)["overall_accuracy"]


def test_bg_bias_moves_decisions_not_losses(report, run, port_side, jax_side):
    cfg, work, test_c, _ = run
    biased = evaluate_model(cfg, test_c, work, bg_bias=2.0, bg_bias_sweep=[0.0, 2.0],
                            device="cpu", save_visualizations=False)
    assert biased["bg_bias"] == 2.0 and biased["test_loss"] == report["test_loss"]
    assert not (port_side[2] != jax_side[3])[port_side[4] > MARGIN].any()
    grid = cfg.grid
    _assert_same(biased["dcase2022"], jax_metrics.dcase2022_metrics(
        port_side[2], port_side[1], grid.n_el, grid.n_az, grid.num_classes))
    sweep = biased["bg_bias_sweep"]
    assert list(sweep["metrics"]) == ["0.0", "2.0"]
    for key, full in (("0.0", report), ("2.0", biased)):
        assert sweep["metrics"][key] == {k: full["dcase2022"][k] for k in sweep["metrics"][key]}
    best = min(sweep["metrics"], key=lambda k: sweep["metrics"][k]["SELD_error"])
    assert sweep["best"] == {"bg_bias": float(best), **sweep["metrics"][best]}
    with pytest.raises(ValueError, match="at least one bias"):
        evaluate_model(cfg, test_c, work, bg_bias_sweep=[], device="cpu")


def test_median_filter_and_its_sweep(report, run, port_side):
    cfg, work, test_c, _ = run
    smoothed = evaluate_model(cfg, test_c, work, median_filter=3, median_filter_sweep=[1, 3],
                              device="cpu", save_visualizations=False)
    grid = cfg.grid
    want = smooth_classes(port_side[0], 3, grid.num_classes)
    _assert_same(smoothed["dcase2022"], port_metrics.dcase2022_metrics(
        want, port_side[1], grid.n_el, grid.n_az, grid.num_classes))
    assert smoothed["median_filter"] == 3 and smoothed["test_loss"] == report["test_loss"]
    sweep = smoothed["median_filter_sweep"]
    assert list(sweep["metrics"]) == ["1", "3"]
    for key, full in (("1", report), ("3", smoothed)):
        assert sweep["metrics"][key] == {k: full["dcase2022"][k] for k in sweep["metrics"][key]}
    assert sweep["best"]["median_filter"] in (1, 3)
    for bad in (dict(median_filter=4), dict(median_filter_sweep=[3, 2]),
                dict(median_filter_sweep=[])):
        with pytest.raises(ValueError):
            evaluate_model(cfg, test_c, work, device="cpu", **bad)


def test_use_checkpoint_latest_fallback_and_refusals(run, tmp_path):
    cfg, work, test_c, _ = run
    latest = evaluate_model(cfg, test_c, work, use_checkpoint="latest", device="cpu",
                            save_visualizations=False)
    assert latest["checkpoint_kind"] == "latest" and latest["checkpoint_epoch"] == 2
    with pytest.raises(ValueError, match="'best' or 'latest'"):
        evaluate_model(cfg, test_c, work, use_checkpoint="newest", device="cpu")
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        evaluate_model(cfg, test_c, tmp_path, device="cpu")
    assert not list(tmp_path.iterdir())  # looking for checkpoints creates nothing
    # only rolling checkpoints: "best" falls back to the newest of them, and says so
    (tmp_path / "rolling").mkdir()
    (tmp_path / "rolling" / "epoch_0002.pt").symlink_to(work / "rolling" / "epoch_0002.pt")
    fallen = evaluate_model(cfg, test_c, tmp_path, device="cpu", save_visualizations=False)
    assert fallen["checkpoint_kind"] == "latest" and fallen["test_loss"] == latest["test_loss"]


def test_architecture_comes_from_the_checkpoint(run, report):
    cfg, work, test_c, _ = run
    other = pc.parse_overrides(cfg, ["model.resnet_conf_d_model=64", "model.resnet_conf_n_heads=4"])
    assert evaluate_model(other, test_c, work, device="cpu",
                          save_visualizations=False)["test_loss"] == report["test_loss"]


def test_report_of_a_preempted_run_says_training_incomplete(run, report):
    cfg, work, test_c, history = run
    hist = work / "training_history.json"
    kept = hist.read_text()
    try:
        hist.write_text(json.dumps({**history, "preempted_epoch": 2}))
        stamped = evaluate_model(cfg, test_c, work, device="cpu", save_visualizations=False)
    finally:
        hist.write_text(kept)
    assert stamped["training_incomplete"] == {"preempted_epoch": 2}
    assert "training_incomplete" not in report
    assert stamped["test_loss"] == report["test_loss"]


def test_best_checkpoint_is_chosen_on_the_validation_metric(run):
    cfg, work, _, history = run
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    vals = [r["val_dcase2022"]["SELD_error"] for r in records]
    assert list(records[0]["val_dcase2022"]) == ["ER", "F_macro", "LE_macro", "LR_macro",
                                                 "SELD_error"]
    assert history["val_metric"] == vals
    assert history["best_val_metric"] == min(vals)
    # the first epoch to reach the least value keeps the checkpoint
    assert history["best_val_epoch"] == 1 + vals.index(min(vals))
    meta = CheckpointManager(work, cfg).best_meta()
    assert meta["select"] == {"metric": "seld_error", "value": min(vals)}
    assert meta["epoch"] == history["best_val_epoch"]
    assert history["best_test_loss"] == min(history["test_losses"])


def test_select_metric_refuses_an_unknown_name(tmp_path):
    with pytest.raises(ValueError, match="select_metric must be one of"):
        train_model(_tiny_cfg(tmp_path, "train.select_metric=accuracy"), None, None,
                    device="cpu")
    assert pc.Config().train.select_metric == "loss"


def _cli_overrides(base):
    return [o for o in TINY if not o.startswith(("train.num", "train.select"))] + [
        f"data.base_path={base}"]


def test_cli_eval_prints_the_report_of_the_run(run, report):
    cfg, work, _, _ = run
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = port_main(["eval", "--synthetic", "--device", "cpu", "--use-checkpoint", "best",
                        "--num-visualizations", "0",
                        "--bg-bias", "0.5", "--median-filter-sweep", "1,3",
                        *_cli_overrides(work.parent)])
    got = printed_json(printed.getvalue())
    assert rc == 0 and "visualizations" not in got
    assert got["checkpoint_epoch"] == report["checkpoint_epoch"] and got["bg_bias"] == 0.5
    assert list(got["median_filter_sweep"]["metrics"]) == ["1", "3"]
    assert "SELD_error" in got["dcase2022"] and np.isfinite(got["test_loss"])


def test_cli_train_eval_after_and_eval_without_a_checkpoint(tmp_path):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = port_main(["train", "--synthetic", "--eval-after", "--device", "cpu",
                        "--num-visualizations", "0",
                        "train.num_epochs=1", "window.hop_seconds=4.0",
                        *[o for o in _cli_overrides(tmp_path) if not o.startswith("window.hop")]])
    got = printed_json(printed.getvalue())
    assert rc == 0 and got["checkpoint_epoch"] == 1 and got["checkpoint_kind"] == "best"
    record = json.loads((tmp_path / "checkpoints" / "metrics.jsonl").read_text())
    assert got["test_loss"] == pytest.approx(record["test"]["loss"], abs=1e-6)
    shutil.rmtree(tmp_path / "checkpoints")
    port_fails(["eval", "--synthetic", "--device", "cpu", "window.hop_seconds=4.0",
               *[o for o in _cli_overrides(tmp_path) if not o.startswith("window.hop")]],
               FileNotFoundError, str(tmp_path / "checkpoints"))
    with pytest.raises(SystemExit):
        port_main(["eval", "--use-checkpoint", "newest"])


def test_cli_verify_reports_every_backbone(capsys):
    assert port_main(["verify", "--frames", "6", "--device", "cpu"]) == 0
    lines = printed_lines(capsys.readouterr().out)
    assert len(lines) == 6
    assert all("(2, 6, 14, 648) OK" in line for line in lines[:4])
    assert [line.split(":")[0].strip() for line in lines] == [
        "resnet_conformer", "cnn", "crnn", "conformer", "accdoa_conformer",
        "multi_accdoa_conformer"]
    assert "(2, 6, 13, 3) OK" in lines[4] and "(2, 6, 3, 13, 3) OK" in lines[5]
    assert port_main(["verify", "--frames", "4", "--device", "cpu",
                      "grid.cell_degrees=30"]) == 0
    assert "(2, 4, 14, 72) OK" in capsys.readouterr().out
