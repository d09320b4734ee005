"""The PNG artifacts of the port against seld_tpu's, on the CPU. Both
packages draw with matplotlib, so the loss curves, the grid predictions,
the replot and the augmentation comparison are held to the JAX package's
PNGs pixel for pixel, and the loss-component dashboard (whose softmax is
numpy here and jax.nn there) panel by panel: every image array at 1e-6,
every title, statistics text and suptitle number by number at 1e-5.
evaluate_model's visualization pass against the JAX package's on the same
weights and corpus: the same frames, records and file names, and each PNG
pair within 1 % of its pixels. Then the trainer's dashboards (the frame
chosen on the device against the JAX rule) and loss curves, the CLI's
--num-visualizations, and the replot and augment_compare tools. Every test
removes what it writes."""

import contextlib
import dataclasses
import io
import json
import logging
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from matplotlib import image as mpimg
from matplotlib import pyplot as plt

from seld_tpu import viz as jax_viz
from seld_tpu.config import Config as JaxConfig
from seld_tpu.config import parse_overrides as jax_overrides
from seld_tpu.data.corpus import WindowedCorpus as JaxCorpus
from seld_tpu.eval import evaluate_model as jax_evaluate_model
from seld_tpu.models import build_model as build_jax_model
from seld_tpu.tools import augment_compare as jax_augment_compare
from seld_tpu.tools import replot as jax_replot
from seld_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from seld_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from seld_tpu.train.state import create_train_state as jax_create_train_state
from seld_tpu_torch import config as pc
from seld_tpu_torch import viz
from seld_tpu_torch.cli import build_parser
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.convert import state_dict_from_jax
from seld_tpu_torch.data.synthetic import synthetic_corpus
from seld_tpu_torch.eval import evaluate as port_evaluate
from seld_tpu_torch.eval import evaluate_model
from seld_tpu_torch.targets.rasterize import bitmask_to_dense
from seld_tpu_torch.tools import augment_compare, replot
from seld_tpu_torch.train import trainer
from seld_tpu_torch.train.checkpoint import save_checkpoint
from seld_tpu_torch.train.trainer import check_mesh_config, train_model
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_predict import _randomize
from tests.torch_cli_helpers import printed_json

N_EL, N_AZ, M = 6, 12, 14
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?|nan")


def _pixels(path) -> np.ndarray:
    """A PNG decoded by matplotlib: (h, w, 4) uint8 RGBA."""
    pixels = np.rint(mpimg.imread(path) * 255).astype(np.uint8)
    assert pixels.ndim == 3 and pixels.shape[-1] == 4 and pixels.size
    return pixels


def _assert_same_text(got: str, want: str, atol=1e-5):
    """Equal text once the numbers are taken out; each number within atol."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want), (got, want)
    g = [float(x) for x in NUMBER.findall(got)]
    w = [float(x) for x in NUMBER.findall(want)]
    np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _assert_same_image_panel(got, want, atol=0.0):
    """Two matplotlib axes show the same image: its array and mask, its
    colormap, limits and labels, and the title."""
    (g,), (w,) = got.images, want.images
    ga, wa = np.ma.asarray(g.get_array()), np.ma.asarray(w.get_array())
    np.testing.assert_array_equal(np.ma.getmaskarray(ga), np.ma.getmaskarray(wa))
    np.testing.assert_allclose(ga.filled(0), wa.filled(0), atol=atol, rtol=0)
    assert g.get_cmap().name == w.get_cmap().name
    np.testing.assert_allclose(g.get_clim(), w.get_clim(), atol=max(atol, 1e-12))
    assert (got.get_xlabel(), got.get_ylabel()) == (want.get_xlabel(), want.get_ylabel())
    _assert_same_text(got.get_title(), want.get_title())


# --- the figures against seld_tpu.viz ------------------------------------------


def test_loss_curves_show_what_jax_draws(tmp_path):
    rng = np.random.default_rng(0)
    for epochs in (7, 1, 0):
        train = rng.uniform(0.1, 1.0, epochs).tolist()
        test = rng.uniform(0.1, 1.0, epochs).tolist()
        viz.plot_loss_curves(train, test, save_path=tmp_path / "port.png")
        jax_viz.plot_loss_curves(train, test, save_path=tmp_path / "jax.png")
        np.testing.assert_array_equal(_pixels(tmp_path / "port.png"),
                                      _pixels(tmp_path / "jax.png"))
    shutil.rmtree(tmp_path)


def _grid_inputs(seed):
    rng = np.random.default_rng(seed)
    labels = np.zeros((M, N_EL * N_AZ), np.float32)
    labels[-1] = 1.0
    cells = rng.choice(N_EL * N_AZ, 9, replace=False)
    labels[:, cells] = 0.0
    labels[rng.integers(0, M - 1, 9), cells] = 1.0
    logits = rng.standard_normal((M, N_EL * N_AZ)).astype(np.float32)
    logits[-1] += 1.5  # mostly background, some events
    return labels, logits


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_predictions_show_what_jax_draws(tmp_path, seed):
    labels, logits = _grid_inputs(seed)
    kw = dict(time_frame=3, grid_size=(N_EL, N_AZ), num_classes=M, title_prefix="Window 2, ")
    viz.visualize_grid_predictions(labels, logits, save_path=tmp_path / "port.png", **kw)
    jax_viz.visualize_grid_predictions(labels, logits, save_path=tmp_path / "jax.png", **kw)
    np.testing.assert_array_equal(_pixels(tmp_path / "port.png"), _pixels(tmp_path / "jax.png"))
    shutil.rmtree(tmp_path)


def _dashboard_inputs(seed=0, b=2, t=5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, M, N_EL * N_AZ)).astype(np.float32)
    logits[:, :, -1] += 2.0
    labels = np.zeros_like(logits)
    labels[:, :, -1] = 1.0
    for bi in range(b):
        for ti in range(t):
            cells = rng.choice(N_EL * N_AZ, rng.integers(0, 8), replace=False)
            labels[bi, ti, :, cells] = 0.0
            labels[bi, ti, rng.integers(0, M - 1, len(cells)), cells] = 1.0
    return logits, labels


def _assert_same_dashboard(got, want):
    """Two loss-component figures: each of the 3 x 4 panels' image arrays at
    1e-6 (or its statistics text), titles and suptitle number by number."""
    assert len(got.axes) == len(want.axes)
    for g, w in zip(got.axes[:12], want.axes[:12]):  # the 3 x 4 grid; the colour bars follow
        if g.images:
            _assert_same_image_panel(g, w, atol=1e-6)
        else:
            (gt,), (wt,) = g.texts, w.texts
            _assert_same_text(gt.get_text(), wt.get_text())
    _assert_same_text(got._suptitle.get_text(), want._suptitle.get_text())


@pytest.mark.parametrize("frame_idx", [None, 2])
def test_loss_components_panels_and_text_match(frame_idx, tmp_path):
    logits, labels = _dashboard_inputs()
    kw = dict(n_el=N_EL, n_az=N_AZ, frame_idx=frame_idx, epoch=4)
    got = viz.visualize_loss_components(logits, labels, save_dir=tmp_path, **kw)
    want = jax_viz.visualize_loss_components(logits, labels, **kw)
    try:
        _assert_same_dashboard(got, want)
    finally:
        plt.close(want)
    suptitle = got._suptitle.get_text()
    if frame_idx is not None:
        assert "batch 0, frame 2" in suptitle
    t = int(re.search(r"frame (\d+)", suptitle).group(1))
    (saved,) = tmp_path.iterdir()
    assert saved.name == f"loss_components_epoch4_f{t}.png"
    _pixels(saved)
    shutil.rmtree(tmp_path)


# --- evaluate_model's visualization pass against the JAX package's --------

GRID_RUN = ["model.resnet_conf_d_model=16", "model.resnet_conf_n_heads=2",
            "model.resnet_conf_n_layers=1", "model.compute_dtype=float32",
            "window.window_seconds=0.4", "window.hop_seconds=0.4", "train.batch_size=4"]
ACCDOA_RUN = ["model.model_type=accdoa_conformer", "model.crnn_cnn_channels=8,16",
              "model.conf_d_model=16", "model.conf_n_heads=2", "model.conf_n_layers=1",
              "model.compute_dtype=float32", "targets.accdoa=true",
              "window.window_seconds=0.4", "window.hop_seconds=0.4", "train.batch_size=4"]
# at most this share of pixels may differ between the two packages' PNGs: a
# cell whose two best logits nearly tie may flip at the eval forward's
# 5e-4 logit tolerance
PIXEL_SHARE = 0.01


def _weights_of_both(base, overrides):
    """Random weights saved as a JAX checkpoint tree and, converted, as the
    port's: (JAX tree, port tree, port corpus, JAX corpus)."""
    jcfg = jax_overrides(JaxConfig(), overrides)
    model = build_jax_model(jcfg.model, jcfg.grid)
    win = jcfg.window.window_frames(jcfg.features)
    state = jax_create_train_state(
        model, jax_make_optimizer(jcfg.train.learning_rate), jax.random.PRNGKey(0),
        np.zeros((jcfg.train.batch_size, win, 4, 64), np.float32))
    randomized = _randomize(state.variables(), seed=3)
    state = state.replace(**randomized)
    mgr = JaxCheckpointManager(base / "jax_ckpt", jcfg)
    mgr.save_best(3, state, 0.0, 0.0)
    mgr.wait()
    mgr.close()
    pcfg = pc.parse_overrides(pc.Config(), overrides)
    variables = jax.tree.map(np.asarray, state.variables())
    save_checkpoint(base / "port_ckpt" / "best" / "epoch_0003.pt",
                    state_dict_from_jax(variables, pcfg.model), pcfg, epoch=3,
                    meta={"epoch": 3, "train_loss": 0.0, "test_loss": 0.0})
    corpus = synthetic_corpus(pcfg, n_files=1, seconds=3.0, seed=1, train=False,
                              event_rate_hz=3.0, device="cpu")
    jax_corpus = JaxCorpus(**{f.name: getattr(corpus, f.name)
                              for f in dataclasses.fields(JaxCorpus)})
    return base / "jax_ckpt", base / "port_ckpt", corpus, jax_corpus


@pytest.fixture(scope="module")
def grid_weights(tmp_path_factory):
    base = tmp_path_factory.mktemp("viz_grid")
    yield GRID_RUN, *_weights_of_both(base, GRID_RUN)
    shutil.rmtree(base, ignore_errors=True)


@pytest.fixture(scope="module")
def accdoa_weights(tmp_path_factory):
    base = tmp_path_factory.mktemp("viz_accdoa")
    yield ACCDOA_RUN, *_weights_of_both(base, ACCDOA_RUN)
    shutil.rmtree(base, ignore_errors=True)


def _reports(weights, tmp_path, monkeypatch, **kw):
    """(port report, JAX report, the port renderer's inputs per PNG)."""
    overrides, jax_ckpt, port_ckpt, corpus, jax_corpus = weights
    drawn = []
    draw = viz.visualize_grid_predictions
    monkeypatch.setattr(viz, "visualize_grid_predictions",
                        lambda gt, pred, **k: drawn.append((gt, pred)) or draw(gt, pred, **k))
    want = jax_evaluate_model(
        jax_overrides(JaxConfig(), [*overrides, f"data.base_path={tmp_path / 'jax'}"]),
        jax_corpus, jax_ckpt, num_visualizations=3, **kw)
    got = evaluate_model(
        pc.parse_overrides(pc.Config(), [*overrides, f"data.base_path={tmp_path / 'port'}"]),
        corpus, port_ckpt, num_visualizations=3, device="cpu", **kw)
    return got, want, drawn


def _assert_same_visualizations(got, want):
    """The same frames, records and file names; each PNG pair of the same
    shape, at most PIXEL_SHARE of its pixels different."""
    assert got["num_frames_with_events"] == want["num_frames_with_events"] >= 3
    keys = ("window_idx", "time_idx", "num_active")
    assert [{k: r[k] for k in keys} for r in got["visualizations"]] == [
        {k: r[k] for k in keys} for r in want["visualizations"]]
    assert all(list(r) == [*keys, "save_path"] for r in got["visualizations"])
    names = [r["save_path"].rsplit("/", 1)[1] for r in got["visualizations"]]
    assert names == [r["save_path"].rsplit("/", 1)[1] for r in want["visualizations"]]
    assert len(names) == 3 and all(n.startswith(f"test_viz_{k + 1}_window")
                                   for k, n in enumerate(names))
    for g, w in zip(got["visualizations"], want["visualizations"]):
        gp, wp = _pixels(g["save_path"]), _pixels(w["save_path"])
        assert gp.shape == wp.shape
        assert (gp != wp).any(axis=-1).mean() <= PIXEL_SHARE


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=1), dict(seed=0, bg_bias=1.0)],
                         ids=["seed0", "seed1", "bg_bias"])
def test_evaluate_model_visualizes_the_frames_jax_does(grid_weights, tmp_path, monkeypatch,
                                                       kw):
    got, want, drawn = _reports(grid_weights, tmp_path, monkeypatch, **kw)
    _assert_same_visualizations(got, want)
    # the drawn ground truth is the chosen frame's, from the corpus's bitmask
    corpus = grid_weights[3]
    for record, (gt, _) in zip(got["visualizations"], drawn):
        mask = corpus.gather([record["window_idx"]])[1][0, record["time_idx"]]
        np.testing.assert_array_equal(gt, bitmask_to_dense(mask, M).T)
    shutil.rmtree(tmp_path)


def test_accdoa_visualizations_render_the_decoded_one_hot(accdoa_weights, tmp_path,
                                                         monkeypatch):
    got, want, drawn = _reports(accdoa_weights, tmp_path, monkeypatch, accdoa_threshold=1.0)
    _assert_same_visualizations(got, want)
    assert len(drawn) == 3
    for _, pred in drawn:  # one-hot class maps of the decoded grid
        assert set(np.unique(pred)) <= {0.0, 1.0} and (pred.sum(axis=0) == 1).all()
    shutil.rmtree(tmp_path)


def test_no_visualizations_no_second_forward(grid_weights, tmp_path, monkeypatch):
    """save_visualizations=False or num_visualizations=0: an empty list, no
    PNG and no forward beyond the scoring pass's one per batch."""
    overrides, _, port_ckpt, corpus, _ = grid_weights
    cfg = pc.parse_overrides(pc.Config(), [*overrides, f"data.base_path={tmp_path}"])
    forwards = []
    build = port_evaluate.build_model

    def counting_build(*args, **kwargs):
        model = build(*args, **kwargs)
        model.register_forward_pre_hook(lambda *_: forwards.append(1))
        return model

    monkeypatch.setattr(port_evaluate, "build_model", counting_build)
    batches = -(-len(corpus) // cfg.train.batch_size)
    for kw, n_png in ((dict(save_visualizations=False), 0), (dict(num_visualizations=0), 0),
                      (dict(num_visualizations=2), 2)):
        forwards.clear()
        report = evaluate_model(cfg, corpus, port_ckpt, device="cpu", **kw)
        assert len(report["visualizations"]) == n_png
        assert len(forwards) == batches + (1 if n_png else 0)
        pngs = sorted((tmp_path / "outputs").rglob("*.png"))
        assert len(pngs) == n_png
    shutil.rmtree(tmp_path)


# --- the trainer: dashboards and loss curves ------------------------------

TRAIN_RUN = ["model.resnet_conf_d_model=16", "model.resnet_conf_n_heads=2",
             "model.resnet_conf_n_layers=1", "model.compute_dtype=float32",
             "grid.cell_degrees=30", "window.window_seconds=0.4", "window.hop_seconds=0.4",
             "train.batch_size=4", "train.num_epochs=2", "train.save_every_n_epochs=1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A two-epoch run with a dashboard every epoch: (cfg, base, test corpus)."""
    base = tmp_path_factory.mktemp("viz_train")
    cfg = pc.parse_overrides(pc.Config(), [*TRAIN_RUN, f"data.base_path={base}",
                                           "train.viz_loss_components_every=1"])
    train_c = synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=0, event_rate_hz=3.0,
                               device="cpu")
    test_c = synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=1, train=False,
                              event_rate_hz=3.0, device="cpu")
    train_model(cfg, train_c, test_c, device="cpu")
    yield cfg, base, test_c
    shutil.rmtree(base, ignore_errors=True)


def test_trainer_writes_dashboards_and_loss_curves(trained):
    cfg, base, _ = trained
    dashboards = sorted(p.name for p in (base / "outputs" / "train_visualizations").iterdir())
    assert [re.sub(r"_f\d+\.png$", "", n) for n in dashboards] == [
        "loss_components_epoch1", "loss_components_epoch2"]
    for name in [*(f"train_visualizations/{n}" for n in dashboards), "loss_curves.png"]:
        pixels = _pixels(base / "outputs" / name)
        assert pixels.ndim == 3 and pixels.shape[-1] == 4 and pixels.size


def test_the_dashboard_forward_raises_and_rendering_only_warns(trained, monkeypatch, caplog):
    cfg, base, test_c = trained

    class Broken(torch.nn.Module):
        def forward(self, x):
            raise RuntimeError("kernel launch failed")

    class Background(torch.nn.Module):
        def forward(self, x):
            return torch.zeros((*x.shape[:2], cfg.grid.num_classes, cfg.grid.n_cells))

    with pytest.raises(RuntimeError, match="kernel launch failed"):
        trainer._loss_dashboard(Broken(), test_c, cfg, torch.device("cpu"), 9)

    def fail(*args, **kwargs):
        raise ValueError("no renderer")

    monkeypatch.setattr(viz, "draw_loss_components", fail)
    with caplog.at_level(logging.WARNING, logger=trainer.logger.name):
        trainer._loss_dashboard(Background(), test_c, cfg, torch.device("cpu"), 9)
    assert "loss-component viz failed: no renderer" in caplog.text
    assert not list((base / "outputs" / "train_visualizations").glob("*epoch9*"))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dashboard_draws_the_frame_jax_picks(trained, tmp_path, monkeypatch, seed):
    """The trainer picks the frame on the device and brings only it to the
    host: the same frame, panels and file name as JAX's
    visualize_loss_components on the whole batch."""
    cfg, _, _ = trained
    cfg = pc.parse_overrides(cfg, [f"data.base_path={tmp_path}"])
    test_c = synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=seed, train=False,
                              event_rate_hz=3.0, device="cpu")
    shape = (cfg.train.batch_size, test_c.window_frames, M, cfg.grid.n_cells)
    logits = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape,
                                                                          np.float32))

    class Fixed(torch.nn.Module):
        def forward(self, x):
            return logits[:x.shape[0]]

    figures = []
    draw = viz.draw_loss_components
    monkeypatch.setattr(viz, "draw_loss_components",
                        lambda *a, **k: figures.append(draw(*a, **k)))
    trainer._loss_dashboard(Fixed(), test_c, cfg, torch.device("cpu"), 3)
    mask = test_c.gather(np.arange(min(len(test_c), cfg.train.batch_size)))[1]
    labels = np.moveaxis(bitmask_to_dense(mask, M), -1, -2)
    want = jax_viz.visualize_loss_components(
        logits[:len(mask)].numpy(), labels, n_el=cfg.grid.n_el, n_az=cfg.grid.n_az,
        epoch=3, save_dir=tmp_path / "jax")
    (got,) = figures
    _assert_same_dashboard(got, want)
    (saved,) = (tmp_path / "outputs" / "train_visualizations").iterdir()
    assert [saved.name] == [p.name for p in (tmp_path / "jax").iterdir()]
    shutil.rmtree(tmp_path)


def test_accdoa_model_warns_and_renders_no_dashboard(tmp_path, caplog):
    cfg = pc.parse_overrides(pc.Config(), [
        *ACCDOA_RUN, f"data.base_path={tmp_path}", "train.num_epochs=1",
        "train.viz_loss_components_every=1"])
    corpus = synthetic_corpus(cfg, n_files=1, seconds=1.0, seed=0, device="cpu")
    with caplog.at_level(logging.WARNING, logger=trainer.logger.name):
        train_model(cfg, corpus, corpus, device="cpu")
    assert "the loss-component dashboard takes grid logits" in caplog.text
    assert not (tmp_path / "outputs" / "train_visualizations").exists()
    assert (tmp_path / "outputs" / "loss_curves.png").exists()
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize("enable", ["on", "auto"])
def test_dashboard_under_a_mesh_of_several_ranks_names_its_roadmap_item(monkeypatch, enable):
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = pc.parse_overrides(pc.Config(), ["train.viz_loss_components_every=1",
                                           f"mesh.enable={enable}"])
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        check_mesh_config(cfg, 250)
    check_mesh_config(pc.parse_overrides(cfg, ["mesh.enable=off"]), 250)


def test_viz_every_is_a_known_field_with_jax_default():
    default = JaxConfig().train.viz_loss_components_every
    assert pc.Config().train.viz_loss_components_every == default
    cfg = pc.parse_overrides(pc.Config(), ["train.viz_loss_components_every=5"])
    assert cfg.train.viz_loss_components_every == 5


# --- the CLI ---------------------------------------------------------------


def test_cli_eval_num_visualizations(trained):
    cfg, base, _ = trained
    over = [o for o in TRAIN_RUN if not o.startswith("train.")] + [f"data.base_path={base}"]
    viz_dir = base / "outputs" / "test_visualizations"
    for n in (2, 0):
        shutil.rmtree(viz_dir, ignore_errors=True)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = port_main(["eval", "--synthetic", "--device", "cpu", "--num-visualizations",
                            str(n), "train.batch_size=4", *over])
        assert rc == 0 and "visualizations" not in printed_json(printed.getvalue())
        pngs = sorted(viz_dir.glob("*.png")) if viz_dir.exists() else []
        assert len(pngs) == n
        assert all(_pixels(p).ndim == 3 for p in pngs)


def test_cli_train_takes_num_visualizations():
    args = build_parser().parse_args(["train", "--eval-after", "--num-visualizations", "2"])
    assert args.num_visualizations == 2
    assert build_parser().parse_args(["eval"]).num_visualizations == 5


# a machine without matplotlib: each import of it fails as a missing module does
WITHOUT_MATPLOTLIB = """
import json, sys

class NoMatplotlib:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)

sys.meta_path.insert(0, NoMatplotlib())
from seld_tpu_torch.cli import main

train, eval_ = json.loads(sys.argv[1]), json.loads(sys.argv[2])
print("train rc", main(["train", "--synthetic", "--device", "cpu", *train]), flush=True)
print("eval rc", main(["eval", "--synthetic", "--device", "cpu", "--num-visualizations", "0",
                       *eval_]), flush=True)
print("eval with PNGs rc", main(["eval", "--synthetic", "--device", "cpu", *eval_]), flush=True)
"""


def test_without_matplotlib_training_goes_on_and_eval_names_it(tmp_path):
    """Where matplotlib is missing, `cli train` with a dashboard every epoch
    trains and warns for each figure, `cli eval --num-visualizations 0`
    scores, and `cli eval` with PNGs fails (rc 1) naming the missing
    module."""
    over = [o for o in TRAIN_RUN if o != "train.num_epochs=2"] + [
        "train.num_epochs=1", f"data.base_path={tmp_path}"]
    res = subprocess.run(
        [sys.executable, "-c", WITHOUT_MATPLOTLIB,
         json.dumps([*over, "train.viz_loss_components_every=1"]), json.dumps(over)],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("rc 0") == 2, res.stdout
    # the failing eval returns 1 and logs its exception (to standard output)
    assert "eval with PNGs rc 1" in res.stdout
    assert "eval failed" in res.stdout
    assert "ModuleNotFoundError: No module named 'matplotlib'" in res.stdout
    assert "loss-component viz failed: No module named 'matplotlib'" in res.stdout
    assert "loss-curve plot failed: No module named 'matplotlib'" in res.stdout
    assert (tmp_path / "checkpoints" / "metrics.jsonl").exists()
    assert not list(tmp_path.rglob("*.png"))
    shutil.rmtree(tmp_path)


# --- the tools ---------------------------------------------------------------


def test_replot_equals_jax(trained, tmp_path):
    _, base, _ = trained
    metrics = base / "checkpoints" / "metrics.jsonl"
    records = replot.load_metrics(metrics)
    assert replot.summarize(records) == jax_replot.summarize(jax_replot.load_metrics(metrics))
    out = replot.replot(metrics, tmp_path / "port.png")
    jax_replot.replot(metrics, tmp_path / "jax.png")
    np.testing.assert_array_equal(_pixels(out), _pixels(tmp_path / "jax.png"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert replot.main([str(metrics), "--out", str(tmp_path / "main.png")]) == 0
    assert printed.getvalue().startswith(replot.summarize(records))
    np.testing.assert_array_equal(_pixels(tmp_path / "main.png"), _pixels(tmp_path / "jax.png"))
    assert replot.replot(metrics) == metrics.parent / "loss_curves_replot.png"
    (metrics.parent / "loss_curves_replot.png").unlink()
    with pytest.raises(ValueError, match="no epoch records"):
        (tmp_path / "empty.jsonl").write_text("\n")
        replot.load_metrics(tmp_path / "empty.jsonl")
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize("frame", [None, 12])
def test_augment_compare_equals_jax(tmp_path, frame):
    rng = np.random.default_rng(5)
    n = 40
    rows = np.stack([rng.integers(0, 30, n), rng.integers(0, 13, n), rng.integers(0, 2, n),
                     rng.integers(-180, 180, n), rng.integers(-90, 91, n)], axis=1)
    csv = tmp_path / "clip.csv"
    np.savetxt(csv, rows[np.argsort(rows[:, 0], kind="stable")], fmt="%d", delimiter=",")
    got = augment_compare.compare_augmentation(csv, 150, save_dir=tmp_path / "port",
                                               frame=frame)
    want = jax_augment_compare.compare_augmentation(csv, 150, save_dir=tmp_path / "jax",
                                                    frame=frame)
    g_fig, w_fig = got.pop("figure"), want.pop("figure")
    assert got == want and got["point_active_cells"] > 0
    assert got["gaussian_active_cells"] > got["point_active_cells"]
    assert g_fig.rsplit("/", 1)[1] == w_fig.rsplit("/", 1)[1]
    np.testing.assert_array_equal(_pixels(g_fig), _pixels(w_fig))
    assert "figure" not in augment_compare.compare_augmentation(csv, 150)
    shutil.rmtree(tmp_path)
