"""The port's serving artifact (seld_tpu_torch/export.py), K3's forward as
an operator, the thread-safe launch counters (F4) and the serving
commands' config overrides, on the CPU at tiny widths: the counterparts of
tests/test_export.py's cases (both programs bit-equal to the live
predictor; `cli export`; from_artifact against the checkpoint predictor at
overlap 0 and 0.5, streaming included, for grid, ACCDOA and multi-ACCDOA
models; `predict --artifact`; `--median-filter 0` over the sidecar's width;
the int8 export's refusals), the refusals, an artifact loaded in a
fresh interpreter with no model code, the port's artifact against JAX's on
the same weights, `torch.library.opcheck` and a CPU export of K3's
operator, and `cli predict data.base_path=RUN` serving the run's best
checkpoint. Every test removes what it writes."""

import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from seld_tpu.export import export_serving as jax_export_serving
from seld_tpu.export import load_serving as jax_load_serving
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.data.audio import write_wav
from seld_tpu_torch.export import export_serving, load_program, load_serving
from seld_tpu_torch.features.spatial import feature_channels
from seld_tpu_torch.infer import SELDPredictor
from seld_tpu_torch.models import build_model
from seld_tpu_torch.ops import flash_attention as k3
from seld_tpu_torch.ops.counters import bump
from seld_tpu_torch.ops.loss_cuda import grid_loss_terms
from seld_tpu_torch.ops.mel_cuda import log_mel_frames
from seld_tpu_torch.ops.ring_attention import ring_flash_attention
from seld_tpu_torch.ops.spatial_cuda import spatial_features
from seld_tpu_torch.stream import stream_predict
from seld_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_predict import _assert_same_decisions
from tests.test_torch_tta import jax_and_port_checkpoints
from tests.torch_cli_helpers import port_fails

SR = 24_000
REPO = Path(__file__).resolve().parents[1]
TINY = ["model.crnn_cnn_channels=8,16", "model.conf_d_model=16", "model.conf_n_heads=2",
        "model.conf_n_layers=1", "model.compute_dtype=float32", "window.window_seconds=0.4",
        "window.hop_seconds=0.4"]
KINDS = {"grid": ["model.model_type=conformer"],
         "accdoa": ["model.model_type=accdoa_conformer", "features.feature_set=mel_iv"],
         "multi_accdoa": ["model.model_type=multi_accdoa_conformer"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """kind -> a run directory holding checkpoints/best/epoch_0002.pt (and an
    older epoch_0001.pt of other weights) of a seeded tiny model."""
    tmp = tmp_path_factory.mktemp("torch_export")
    out = {}
    for i, (kind, over) in enumerate(KINDS.items()):
        cfg = pc.parse_overrides(pc.Config(), [*TINY, *over])
        for epoch in (1, 2):
            model = build_model(cfg.model, cfg.grid, device="cpu", seed=10 * i + epoch,
                                in_channels=feature_channels(cfg.features.feature_set))
            save_checkpoint(tmp / kind / "checkpoints" / "best" / f"epoch_000{epoch}.pt",
                            model, cfg, epoch=epoch)
        out[kind] = tmp / kind
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


def _best(run):
    return run / "checkpoints" / "best" / "epoch_0002.pt"


@pytest.fixture(scope="module")
def artifact(runs, tmp_path_factory):
    """The grid run's best checkpoint exported for the CPU at batch 2."""
    tmp = tmp_path_factory.mktemp("grid_artifact")
    yield export_serving(_best(runs["grid"]), tmp / "model.pt2", batch_windows=2, device="cpu")
    shutil.rmtree(tmp, ignore_errors=True)


def _copy(artifact, directory, **sidecar):
    """A copy of the artifact's three files in `directory`, the sidecar's
    keys updated."""
    for suffix in ("", ".probs", ".json"):
        shutil.copy(f"{artifact}{suffix}", directory / f"{artifact.name}{suffix}")
    out = directory / artifact.name
    meta = json.loads(Path(f"{out}.json").read_text())
    Path(f"{out}.json").write_text(json.dumps({**meta, **sidecar}))
    return out


def _clip(seconds, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, int(seconds * SR))) * 0.1).astype(np.float32)


def _mel(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def test_export_roundtrip_matches_predictor(runs, artifact):
    out = artifact
    assert out.exists() and out.stat().st_size > 1000
    sidecar = json.loads(Path(f"{out}.json").read_text())
    assert sidecar["model_type"] == "conformer" and sidecar["input_shape"][0] == 2
    assert sidecar["platforms"] == ["cpu"] and sidecar["source_epoch"] == 2
    assert sidecar["quantized_int8"] is False and sidecar["has_probs"] is True

    fn, meta = load_serving(out)
    assert meta == sidecar
    mel = _mel(sidecar["input_shape"])
    p = SELDPredictor(_best(runs["grid"]), batch_windows=2, device="cpu")
    exported = fn(mel)
    assert exported.dtype == torch.int8
    assert torch.equal(exported, p._forward(mel))
    probs = load_program(Path(f"{out}.probs"))
    assert torch.equal(probs(mel), p._forward_probs(mel))


def test_cli_export(runs, tmp_path):
    rc = port_main(["export", f"data.base_path={runs['grid']}", "--out",
                    str(tmp_path / "m.pt2"), "--batch-windows", "1", "--median-filter", "5",
                    "--device", "cpu"])
    assert rc == 0
    for suffix in ("", ".probs", ".json"):
        assert (tmp_path / f"m.pt2{suffix}").exists()
    sidecar = json.loads((tmp_path / "m.pt2.json").read_text())
    assert sidecar["source_epoch"] == 2  # the newest best checkpoint
    assert (sidecar["batch_windows"], sidecar["median_filter"]) == (1, 5)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_export_artifact_is_model_code_free(artifact, tmp_path):
    """A fresh interpreter loads and runs the artifact with torch and K3's
    operator registration alone: no model module, no JAX."""
    out = artifact
    code = f"""
import sys
import torch
from seld_tpu_torch.export import load_serving
fn, meta = load_serving(r"{out}")
y = fn(torch.zeros(meta["input_shape"]))
assert y.dtype == torch.int8 and y.dim() == 3
loaded = [m for m in sys.modules
          if m.startswith(("seld_tpu_torch.models", "jax", "flax", "seld_tpu."))
          or m == "seld_tpu"]
assert not loaded, loaded
assert "seld_tpu_torch.ops.flash_attention" in sys.modules
print("STANDALONE OK", tuple(y.shape))
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "STANDALONE OK" in r.stdout
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("flags", [["--int8-calib-wavs", "c.wav"], ["--int8-weight-only"]],
                         ids=["calib_wavs", "weight_only"])
def test_int8_export_is_refused_naming_item_9(runs, tmp_path, flags):
    """int8 export (ROADMAP item 9) is ported; what it refuses, it refuses as
    the JAX package does, before any file is written: calibration audio
    that is not there, and --int8-weight-only without --int8-calib-wavs."""
    argv = ["export", f"data.base_path={runs['grid']}", "--out", str(tmp_path / "m.pt2"),
            "--device", "cpu", *[str(tmp_path / f) if f.endswith(".wav") else f for f in flags]]
    if "--int8-weight-only" in flags:
        port_fails(argv, ValueError, "--int8-weight-only requires --int8-calib-wavs")
    else:
        port_fails(argv, FileNotFoundError)
    assert not (tmp_path / "m.pt2").exists()


@pytest.mark.parametrize("kind", list(KINDS))
def test_from_artifact_predictor_matches_checkpoint(runs, artifact, tmp_path, kind):
    """from_artifact serves every offline mode bit-equal to the checkpoint
    predictor: plain tiling, overlapped averaging (the .probs program) and
    streaming; TTA raises."""
    threshold = 0.3 if kind != "grid" else None
    out = export_serving(_best(runs[kind]), tmp_path / "full.pt2", batch_windows=2,
                         accdoa_threshold=threshold, device="cpu")
    if kind == "grid":
        assert Path(f"{out}.json").read_text() == Path(f"{artifact}.json").read_text()
    live = SELDPredictor(_best(runs[kind]), batch_windows=2, accdoa_threshold=threshold,
                         device="cpu")
    art = SELDPredictor.from_artifact(out, device="cpu")
    assert (art.batch_windows, art.win, art.kind) == (2, live.win, live.kind)
    assert art.cfg == live.cfg and art.accdoa_threshold == live.accdoa_threshold
    wave = _clip(2.1)
    for overlap in (0.0, 0.5):
        want = live.predict_waveform(wave, overlap=overlap).classes
        np.testing.assert_array_equal(art.predict_waveform(wave, overlap=overlap).classes,
                                      want)
        chunks = [wave[:, i:i + SR // 2] for i in range(0, wave.shape[1], SR // 2)]
        np.testing.assert_array_equal(stream_predict(art, chunks, overlap=overlap).classes,
                                      want)
    assert (want != live.cfg.grid.num_classes - 1).any()
    with pytest.raises(RuntimeError, match="plain forward"):
        art.tta()
    shutil.rmtree(tmp_path, ignore_errors=True)


def _csv(out_dir, wav):
    return (Path(out_dir) / "predictions" / f"{Path(wav).stem}.csv").read_text()


@pytest.fixture
def wav(tmp_path):
    path = tmp_path / "clip.wav"
    write_wav(path, _clip(2.0, seed=3), SR)
    yield path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_predict_from_artifact(runs, artifact, wav):
    """predict --artifact writes the checkpoint's CSV; a bias or threshold
    with --artifact is refused in the JAX package's words."""
    tmp, run = wav.parent, runs["grid"]
    assert port_main(["predict", f"data.base_path={run}", "--wavs", str(wav), "--out",
                      str(tmp / "from_ckpt"), "--device", "cpu"]) == 0
    assert port_main(["predict", f"data.base_path={run}", "--artifact", str(artifact),
                      "--wavs", str(wav), "--out", str(tmp / "from_artifact"),
                      "--device", "cpu"]) == 0
    assert _csv(tmp / "from_artifact", wav) == _csv(tmp / "from_ckpt", wav)
    port_fails(["predict", "--artifact", str(artifact), "--bg-bias", "1",
               "--wavs", str(wav), "--device", "cpu"],
               ValueError, "--bg-bias does not compose with --artifact: the "
               r"bias is baked at export time \(export --bg-bias\)")
    port_fails(["predict", "--artifact", str(artifact), "--accdoa-threshold",
               "0.4", "--wavs", str(wav), "--device", "cpu"],
               ValueError, "--accdoa-threshold does not compose with "
               "--artifact: the threshold is baked at export time")


def test_predict_artifact_median_filter_zero_overrides_sidecar(runs, artifact, wav):
    """A width recorded at export (the sidecar's) applies by default in
    from_artifact, and `predict --artifact --median-filter 0` turns it off."""
    tmp, run = wav.parent, runs["grid"]
    mf = _copy(artifact, tmp, median_filter=5)
    assert SELDPredictor.from_artifact(mf, device="cpu").median_filter == 5
    assert port_main(["predict", "--checkpoint", str(_best(run)), "--wavs", str(wav),
                      "--out", str(tmp / "raw"), "--device", "cpu"]) == 0
    assert port_main(["predict", "--artifact", str(mf), "--median-filter", "0",
                      "--wavs", str(wav), "--out", str(tmp / "off"), "--device", "cpu"]) == 0
    assert port_main(["predict", "--artifact", str(mf), "--wavs", str(wav),
                      "--out", str(tmp / "on"), "--device", "cpu"]) == 0
    assert _csv(tmp / "off", wav) == _csv(tmp / "raw", wav)
    assert _csv(tmp / "on", wav) != _csv(tmp / "raw", wav)


def test_refusals(runs, artifact, tmp_path):
    """--calibration with --artifact; export --calibration of a file tuned
    under TTA; an artifact loaded onto another device type."""
    run = runs["grid"]
    calib = tmp_path / "tta.json"
    calib.write_text(json.dumps({"calibration_version": 1, "model_type": "conformer",
                                 "feature_set": "mel", "bg_bias": 0.5, "median_filter": 3,
                                 "tta": True, "tta_transforms": [0, 4]}))
    port_fails(["predict", "--artifact", str(tmp_path / "m.pt2"), "--calibration",
               str(calib), "--wavs", "x.wav", "--device", "cpu"],
               ValueError, "--calibration does not compose with --artifact")
    port_fails(["export", f"data.base_path={run}", "--out", str(tmp_path / "m.pt2"),
               "--calibration", str(calib), "--device", "cpu"],
               ValueError, "tuned under TTA, which this command cannot apply")
    out = _copy(artifact, tmp_path, platforms=["cuda"])
    with pytest.raises(ValueError, match=r"exported for \['cuda'\] and cannot run on cpu"):
        SELDPredictor.from_artifact(out, device="cpu")
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_export_calibration_bakes_the_decode(runs, tmp_path):
    """export --calibration: the bias goes into the programs and the width
    into the sidecar, as the flags would put them."""
    run = runs["grid"]
    calib = tmp_path / "c.json"
    calib.write_text(json.dumps({"calibration_version": 1, "model_type": "conformer",
                                 "feature_set": "mel", "bg_bias": 0.5, "median_filter": 3}))
    assert port_main(["export", f"data.base_path={run}", "--out", str(tmp_path / "a.pt2"),
                      "--calibration", str(calib), "--device", "cpu"]) == 0
    sidecar = json.loads((tmp_path / "a.pt2.json").read_text())
    assert (sidecar["bg_bias"], sidecar["median_filter"]) == (0.5, 3)
    art = SELDPredictor.from_artifact(tmp_path / "a.pt2", device="cpu")
    live = SELDPredictor(_best(run), bg_bias=0.5, median_filter=3, device="cpu")
    wave = _clip(1.5)
    np.testing.assert_array_equal(art.predict_waveform(wave).classes,
                                  live.predict_waveform(wave).classes)
    shutil.rmtree(tmp_path, ignore_errors=True)


# --- against the JAX package's artifact ------------------------------------------------


def test_port_artifact_matches_jax_artifact(tmp_path):
    """The same weights exported by both packages: the same seeded mel
    through both programs gives the same decisions outside the margin band
    of the two float32 forwards, and the sidecars agree key by key (the
    configs as the port reads them), but for `platforms`."""
    jax_ckpt, port_path = jax_and_port_checkpoints(
        tmp_path, ["model.model_type=conformer", *TINY[:5]], batch=2)
    cfg, state, _ = load_checkpoint(port_path)
    save_checkpoint(port_path, state, cfg, epoch=1)  # the JAX tree's epoch
    jax_out = jax_export_serving(jax_ckpt, tmp_path / "jax.stablehlo", batch_windows=2)
    port_out = export_serving(port_path, tmp_path / "port.pt2", batch_windows=2, device="cpu")
    jax_fn, jax_meta = jax_load_serving(jax_out)
    port_fn, port_meta = load_serving(port_out)
    mel = _mel(port_meta["input_shape"], seed=4)
    got = port_fn(mel).numpy().reshape(-1, port_meta["n_el"] * port_meta["n_az"])
    want = np.asarray(jax_fn(mel.numpy())).reshape(got.shape)
    p = SELDPredictor(port_path, batch_windows=2, device="cpu")
    top = torch.topk(p._raw_apply(mel), 2, dim=2).values
    margin = (top[:, :, 0] - top[:, :, 1]).reshape(got.shape).numpy()
    _assert_same_decisions(want, got, margin)
    assert (got != 13).any()
    assert set(port_meta) == set(jax_meta)
    for key in set(port_meta) - {"platforms", "config"}:
        assert port_meta[key] == jax_meta[key], key
    assert pc.config_from_dict(jax_meta["config"]) == pc.config_from_dict(port_meta["config"])
    shutil.rmtree(tmp_path, ignore_errors=True)


# --- K3's forward as an operator ------------------------------------------------------


def _qkv(b=2, h=2, t=40, dh=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, h, t, dh, generator=g) for _ in range(3))


def test_k3_operator_passes_opcheck():
    q, k, v = _qkv()
    torch.library.opcheck(k3.flash_attention_fwd, (q, k, v, 0.25))
    out, lse = torch.ops.seld_tpu_torch.flash_attention_fwd(q, k, v, 0.25)
    want_out, want_lse = k3.flash_attention_reference(q, k, v, 0.25)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert out.transpose(1, 2).is_contiguous()  # stored (B, T, H, Dh), as the kernel's


def test_k3_operator_exports_into_the_graph():
    """A module around flash_attention exports on the CPU with the operator
    in its graph (eager calls keep the direct path), and the exported
    program equals the plain version."""

    class Attend(torch.nn.Module):
        def forward(self, q, k, v):
            return k3.flash_attention(q, k, v).transpose(1, 2).reshape(2, 40, 32)

    q, k, v = _qkv(seed=1)
    with torch.no_grad():
        program = torch.export.export(Attend(), (q, k, v))
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count("seld_tpu_torch.flash_attention_fwd.default") == 1
    want = k3.flash_attention_reference(q, k, v)[0].transpose(1, 2).reshape(2, 40, 32)
    assert torch.equal(program.module()(q, k, v), want)


# --- F4: launch counters under threads ---------------------------------------------------

COUNTERS = [(log_mel_frames, "launches"), (log_mel_frames, "mixed_launches"),
            (log_mel_frames, "dft_launches"), (grid_loss_terms, "fwd_launches"),
            (grid_loss_terms, "bwd_launches"), (k3.flash_attention, "fwd_launches"),
            (k3.flash_attention, "bwd_dq_launches"), (k3.flash_attention, "bwd_dkv_launches"),
            (k3.flash_attention, "copies"), (spatial_features, "launches"),
            (spatial_features, "mixed_launches"), (spatial_features, "dft_launches"),
            (ring_flash_attention, "fwd_launches")]


@pytest.mark.parametrize("fn,name", COUNTERS,
                         ids=[f"{f.__name__}.{n}" for f, n in COUNTERS])
def test_launch_counter_is_exact_under_threads(fn, name):
    """F4: 8 threads bump one wrapper's counter 10,000 times each through
    the helper every wrapper uses, with the interpreter switching threads
    as often as it can; the count is exact."""
    saved, interval = getattr(fn, name), sys.getswitchinterval()
    setattr(fn, name, 0)
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [bump(fn, name) for _ in range(10_000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert getattr(fn, name) == 80_000
    finally:
        sys.setswitchinterval(interval)
        setattr(fn, name, saved)


# --- the serving commands' config overrides --------------------------------------------


def test_cli_predict_overrides_serve_the_runs_best_checkpoint(runs, wav):
    """`predict data.base_path=RUN` without --checkpoint serves the newest
    best checkpoint and writes under RUN/outputs/predictions: the CSV of
    --checkpoint of that file."""
    run = runs["grid"]
    assert port_main(["predict", f"data.base_path={run}", "--wavs", str(wav),
                      "--device", "cpu"]) == 0
    assert port_main(["predict", "--checkpoint", str(_best(run)), "--wavs", str(wav),
                      "--out", str(wav.parent / "explicit"), "--device", "cpu"]) == 0
    assert port_main(["predict", "--checkpoint",
                      str(run / "checkpoints" / "best" / "epoch_0001.pt"), "--wavs", str(wav),
                      "--out", str(wav.parent / "older"), "--device", "cpu"]) == 0
    got = _csv(run / "outputs", wav)
    shutil.rmtree(run / "outputs")
    assert got == _csv(wav.parent / "explicit", wav)
    assert got != _csv(wav.parent / "older", wav)
    port_fails(["predict", f"data.base_path={wav.parent}", "--wavs", str(wav),
               "--device", "cpu"], FileNotFoundError, "no best checkpoint")
