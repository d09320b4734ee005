"""The port's streaming daemon (seld_tpu_torch/serve.py) on the CPU at tiny
widths: the counterparts of tests/test_serve.py's cases (every served
stream bit-equal to the port's offline predict, plain and overlapped,
sequential and concurrent, batched across streams or not; the protocol's
errors; the max_streams exit; the batcher's packing, its fn boundaries,
its error path, its queue drain and its close; a stream served from an
artifact), int8's refusals, `cli serve`, and against
the JAX package: its client driving the port's server, the port's served
stream against seld_tpu's offline predict on the same weights, and batch
rows permuted bit-equal for each tiny backbone. Every thread join and
socket waits at most 60 s; servers bind port 0 and close in finalizers;
every test removes what it writes."""

import json
import logging
import re
import shutil
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from seld_tpu.infer import SELDPredictor as JaxPredictor
from seld_tpu.serve import stream_client as jax_stream_client
from seld_tpu_torch import config as pc
from seld_tpu_torch.cli import main as port_main
from seld_tpu_torch.export import export_serving
from seld_tpu_torch.features.spatial import feature_channels
from seld_tpu_torch.infer import SELDPredictor
from seld_tpu_torch.models import build_model
from seld_tpu_torch.serve import SELDServer, WindowBatcher, stream_client
from seld_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_predict import _assert_same_decisions
from tests.test_torch_stream import _logit_margin
from tests.test_torch_tta import jax_and_port_checkpoints
from tests.torch_cli_helpers import port_fails

SR = 24_000
WAIT = 60  # seconds: every join, wait and socket read
TINY = ["model.crnn_cnn_channels=8,16", "model.conf_d_model=16", "model.conf_n_heads=2",
        "model.conf_n_layers=1", "model.compute_dtype=float32", "window.window_seconds=0.4",
        "window.hop_seconds=0.4"]


def _checkpoint(path, overrides, seed=0):
    cfg = pc.parse_overrides(pc.Config(), [*TINY, *overrides])
    model = build_model(cfg.model, cfg.grid, device="cpu", seed=seed,
                        in_channels=feature_channels(cfg.features.feature_set))
    save_checkpoint(path, model, cfg, epoch=1)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    yield _checkpoint(tmp / "conformer.pt", ["model.model_type=conformer"])
    shutil.rmtree(tmp, ignore_errors=True)


def _serve(predictor, **kw):
    s = SELDServer(predictor, port=0, **kw)
    return s, s.serve_background()


def _close(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=WAIT)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def server(ckpt):
    s, t = _serve(SELDPredictor(ckpt, batch_windows=1, device="cpu"))
    yield s
    _close(s, t)


def _chunks(wave, n=6000):
    return [wave[:, i:i + n] for i in range(0, wave.shape[1], n)]


def _client(port, chunks, **kw):
    return stream_client("127.0.0.1", port, chunks, timeout=WAIT, **kw)


@pytest.fixture(scope="module")
def wave():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((4, SR * 3)) * 0.1).astype(np.float32)


def _run_threads(targets):
    threads = [threading.Thread(target=fn) for fn in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


def test_served_stream_is_bit_equal_to_offline(server, wave):
    classes, info = _client(server.port, _chunks(wave))
    np.testing.assert_array_equal(classes, server.predictor.predict_waveform(wave).classes)
    assert info["total_samples"] == wave.shape[1]


def test_served_overlap_matches_offline(server, wave):
    classes, _ = _client(server.port, _chunks(wave), overlap=0.5)
    ref = server.predictor.predict_waveform(wave, overlap=0.5)
    np.testing.assert_array_equal(classes, ref.classes)


def test_sample_rate_mismatch_is_reported(server, wave):
    with pytest.raises(RuntimeError, match="sample rate"):
        _client(server.port, _chunks(wave), sample_rate=16000)


def test_bad_chunk_length_is_reported(server):
    with socket.create_connection(("127.0.0.1", server.port), timeout=WAIT) as sock:
        f = sock.makefile("rwb")
        f.write(b'{"channels": 4}\n')
        f.write(struct.pack("<I", 7))  # not a multiple of 4 * channels
        f.write(b"1234567")
        f.flush()
        msg = json.loads(f.readline().decode())
    assert "error" in msg and "byte-length" in msg["error"]


def test_two_sequential_streams_are_independent(server, wave):
    a, _ = _client(server.port, _chunks(wave))
    b, _ = _client(server.port, _chunks(wave, n=9001))
    np.testing.assert_array_equal(a, b)  # the chunking does not matter


def test_concurrent_streams(server, wave):
    results = {}

    def run(name, n):
        results[name] = _client(server.port, _chunks(wave, n=n))[0]

    _run_threads([lambda i=i: run(f"t{i}", 4000 + 1000 * i) for i in range(3)])
    ref = server.predictor.predict_waveform(wave)
    assert len(results) == 3
    for name, classes in results.items():
        np.testing.assert_array_equal(classes, ref.classes, err_msg=name)


def test_max_streams_clean_exit(ckpt, wave):
    """max_streams=N shuts the server down after N completed streams; a
    bare connect and a failed handshake do not count."""
    s, t = _serve(SELDPredictor(ckpt, batch_windows=1, device="cpu"), max_streams=1)
    try:
        with socket.create_connection(("127.0.0.1", s.port), timeout=WAIT):
            pass
        with pytest.raises(RuntimeError, match="sample rate"):
            _client(s.port, _chunks(wave), sample_rate=1)
        assert t.is_alive(), "failed probes must not consume max_streams"
        classes, _ = _client(s.port, _chunks(wave))
        assert classes.shape[1] == 648
        t.join(timeout=WAIT)
        assert not t.is_alive(), "the server did not shut down after max_streams"
    finally:
        s.server_close()


@pytest.mark.parametrize("artifact", [False, True], ids=["checkpoint", "artifact"])
def test_served_int8_is_refused(ckpt, tmp_path, artifact):
    """int8 serving (ROADMAP item 9) is ported (tests/test_torch_quant.py
    serves it); what it refuses: calibration audio that is not there,
    before a port is bound, and, with --artifact, the JAX package's refusal
    word for word."""
    wav = tmp_path / "calib.wav"
    args = ["serve", "--checkpoint", str(ckpt), "--port", "0", "--device", "cpu",
            "--int8-calib-wavs", str(wav)]
    if artifact:
        port_fails([*args, "--artifact", str(tmp_path / "a.pt2")],
                   ValueError, "--int8-calib-wavs does not compose with "
                   "--artifact: int8 is baked at export time")
    else:
        port_fails(args, FileNotFoundError)
    shutil.rmtree(tmp_path, ignore_errors=True)


def _random_windows(p, k, seed=0):
    c = feature_channels(p.cfg.features.feature_set, p.cfg.model.n_channels)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((k, p.win, c, p.cfg.model.n_mels)
                                                ).astype(np.float32))


def _direct(p, windows, fn=None):
    return torch.cat(list(p._batched(windows, fn or p._forward)))


def test_window_batcher_packs_and_matches(ckpt):
    """Requests from two threads, the second's windows in the slots after
    the first's, pack into shared calls and every row is bit-equal to the
    solo zero-padded path; a request larger than the batch splits across
    calls."""
    p = SELDPredictor(ckpt, batch_windows=4, device="cpu")
    windows = _random_windows(p, 4)
    direct = _direct(p, windows)
    b = WindowBatcher(p, max_wait_s=0.3)
    outs = {}
    _run_threads([lambda: outs.setdefault("a", b(p._forward, windows[:2])),
                  lambda: outs.setdefault("b", b(p._forward, windows[2:], 2))])
    b.close()
    assert torch.equal(torch.cat([outs["a"], outs["b"]]), direct)
    # one call: the two p._forward are equal bound methods, not one object
    assert (b.rows_run, b.batches_run) == (4, 1)
    b2 = WindowBatcher(p, max_wait_s=0.0)
    big = _random_windows(p, 9, seed=1)
    assert torch.equal(b2(p._forward, big), _direct(p, big))
    assert b2.batches_run == 3  # 4 + 4 + 1
    b2.close()


def test_window_batcher_mixed_fns_never_share(ckpt):
    """Class-grid and representation requests never share a call."""
    p = SELDPredictor(ckpt, batch_windows=4, device="cpu")
    w = _random_windows(p, 2, seed=2)
    calls = []

    def grid(x):
        calls.append("grid")
        return p._forward(x)

    def probs(x):
        calls.append("probs")
        return p._forward_probs(x)

    b = WindowBatcher(p, max_wait_s=0.2)
    outs = {}
    _run_threads([lambda: outs.setdefault("cls", b(grid, w)),
                  lambda: outs.setdefault("pb", b(probs, w))])
    b.close()
    assert torch.equal(outs["cls"], _direct(p, w))
    assert torch.equal(outs["pb"], _direct(p, w, p._forward_probs))
    assert sorted(calls) == ["grid", "probs"] and b.rows_run == 4


def test_batched_server_concurrent_streams_bit_equal(ckpt, wave):
    """--batch-streams with concurrent clients: every stream, plain and
    overlapped, bit-equal to the offline predict; server_close unhooks the
    batcher."""
    p = SELDPredictor(ckpt, batch_windows=4, device="cpu")
    s, t = _serve(p, batch_streams=True, batch_wait_s=0.05)
    results = {}

    def run(name, n, overlap):
        results[name] = _client(s.port, _chunks(wave, n=n), overlap=overlap)[0]

    try:
        _run_threads([lambda: run("p0", 4000, 0.0), lambda: run("p1", 7000, 0.0),
                      lambda: run("ov", 6000, 0.5)])
    finally:
        _close(s, t)
    assert p.dispatch is None
    np.testing.assert_array_equal(results["p0"], p.predict_waveform(wave).classes)
    np.testing.assert_array_equal(results["p1"], p.predict_waveform(wave).classes)
    np.testing.assert_array_equal(results["ov"], p.predict_waveform(wave, overlap=0.5).classes)
    assert s.batcher.rows_run > 0


def test_window_batcher_error_path_drops_leftover_rows(ckpt):
    """A failed call raises in the waiting caller, runs none of the failed
    request's other rows, and leaves the batcher serving."""
    p = SELDPredictor(ckpt, batch_windows=2, device="cpu")
    b = WindowBatcher(p, max_wait_s=0.0)
    calls = []

    def boom(chunk):
        calls.append(1)
        raise RuntimeError("device exploded")

    err = {}

    def submit():
        try:
            b(boom, _random_windows(p, 5, seed=3))  # 3 calls at batch 2
        except RuntimeError as e:
            err["e"] = e

    _run_threads([submit])
    assert "device exploded" in str(err["e"])
    w = _random_windows(p, 2, seed=4)
    assert torch.equal(b(p._forward, w), _direct(p, w))
    b.close()
    assert len(calls) == 1, f"leftover rows were run: {len(calls)} calls"


def test_window_batcher_packs_pending_without_wait(ckpt):
    """At max_wait 0, requests that arrive while a call runs pack into one
    call when it ends (the queue drain), not one call each; their windows
    take slots 1, 2 and 3."""
    p = SELDPredictor(ckpt, batch_windows=4, device="cpu")
    calls = []
    gate = threading.Event()

    def slow_fn(chunk):
        calls.append(int(chunk.shape[0]))
        if len(calls) == 1:
            gate.wait(timeout=WAIT)  # hold the first call
        return p._forward(chunk)

    b = WindowBatcher(p, max_wait_s=0.0)
    w = _random_windows(p, 1, seed=5)
    direct = _direct(p, w)
    outs = {}
    threads = [threading.Thread(target=lambda i=i: outs.setdefault(i, b(slow_fn, w, i)))
               for i in range(4)]
    threads[0].start()
    for _ in range(600):
        if calls:
            break
        time.sleep(0.01)
    assert calls, "the first request never ran"
    for t in threads[1:]:
        t.start()
    time.sleep(0.3)  # the other three queue while the first call runs
    gate.set()
    for t in threads:
        t.join(timeout=WAIT)
    b.close()
    assert not any(t.is_alive() for t in threads)
    assert b.batches_run == 2, f"expected 1 solo + 1 packed call, got {calls}"
    assert b.rows_run == 4
    for i in range(4):
        assert torch.equal(outs[i], direct)


def _slot_marks(x):
    """A forward whose row depends on its slot: row s of the batch gets s."""
    return x[:, :1, :1, :1] + torch.arange(x.shape[0], dtype=x.dtype).view(-1, 1, 1, 1)


def test_window_batcher_puts_each_row_in_its_slot(ckpt):
    """Each row runs in the slot its request names (its window's offline
    slot: on the card a row's output depends on its slot), two rows never
    share a slot, and requests whose slots are free share a call."""
    p = SELDPredictor(ckpt, batch_windows=4, device="cpu")
    calls = []
    gate = threading.Event()

    def marks(chunk):
        calls.append((chunk[:, 0, 0, 0] != 0).nonzero().flatten().tolist())
        if len(calls) == 1:
            gate.wait(timeout=WAIT)
        return _slot_marks(chunk)

    b = WindowBatcher(p, max_wait_s=0.0)
    rows = {name: torch.full((n, 2, 1, 1), 100.0 * (i + 1))
            for i, (name, n) in enumerate((("a", 1), ("b", 3), ("c", 2), ("d", 1)))}
    first = {"a": 0, "b": 2, "c": 1, "d": 1}
    outs = {}
    threads = [threading.Thread(target=lambda k=k: outs.setdefault(k, b(marks, rows[k],
                                                                      first[k])))
               for k in rows]
    threads[0].start()
    for _ in range(600):
        if calls:
            break
        time.sleep(0.01)
    for t in threads[1:]:
        t.start()
        time.sleep(0.1)  # queued in order b, c, d while a's call runs
    gate.set()
    for t in threads:
        t.join(timeout=WAIT)
    b.close()
    assert not any(t.is_alive() for t in threads)
    # a alone; then b in slots 2, 3 and (wrapping) 0, c's first row in 1 (its
    # second wants 2: taken) and d (wants 1: taken) wait; then c's second row
    # in 2 beside d in 1
    assert calls == [[0], [0, 1, 2, 3], [1, 2]]
    for k, n in (("a", 1), ("b", 3), ("c", 2), ("d", 1)):
        slots = (first[k] + torch.arange(n)) % 4
        want = rows[k][:, :1, :1, :1] + slots.view(-1, 1, 1, 1).float()
        assert torch.equal(outs[k], want), k


def test_batched_stream_keeps_offline_slots(ckpt, wave):
    """A forward whose rows depend on their slot: concurrent streams served
    with --batch-streams still equal the offline predict, plain and
    overlapped, because each window runs in its offline slot."""
    p = SELDPredictor(ckpt, batch_windows=4, device="cpu")
    forward, forward_probs = p._forward, p._forward_probs
    shift = torch.arange(4, dtype=torch.float32).view(-1, 1, 1, 1) * 0.5
    p._forward = lambda x: forward(x + shift)
    p._forward_probs = lambda x: forward_probs(x + shift)
    s, t = _serve(p, batch_streams=True)
    results = {}

    def run(name, n, overlap):
        results[name] = _client(s.port, _chunks(wave, n=n), overlap=overlap)[0]

    try:
        _run_threads([lambda: run("a", 5000, 0.0), lambda: run("b", 9000, 0.0),
                      lambda: run("c", 7000, 0.5)])
    finally:
        _close(s, t)
    np.testing.assert_array_equal(results["a"], p.predict_waveform(wave).classes)
    np.testing.assert_array_equal(results["b"], p.predict_waveform(wave).classes)
    np.testing.assert_array_equal(results["c"], p.predict_waveform(wave, overlap=0.5).classes)
    assert not np.array_equal(p.predict_waveform(wave).classes,
                              SELDPredictor(ckpt, batch_windows=4, device="cpu")
                              .predict_waveform(wave).classes)  # the slots do matter here


def test_window_batcher_close_never_strands_callers(ckpt):
    """close() while a two-batch request runs raises in its caller and
    refuses later requests."""
    p = SELDPredictor(ckpt, batch_windows=4, device="cpu")
    gate = threading.Event()
    started = threading.Event()

    def slow_fn(chunk):
        started.set()
        gate.wait(timeout=WAIT)
        return p._forward(chunk)

    b = WindowBatcher(p, max_wait_s=0.0)
    err = {}

    def submit():
        try:
            b(slow_fn, _random_windows(p, 6, seed=6))
            err["e"] = None
        except RuntimeError as e:
            err["e"] = e

    t = threading.Thread(target=submit)
    t.start()
    assert started.wait(timeout=WAIT)
    closer = threading.Thread(target=b.close)
    closer.start()
    time.sleep(0.1)
    gate.set()  # the running batch ends; the worker must then exit
    closer.join(timeout=WAIT)
    t.join(timeout=WAIT)
    assert not t.is_alive() and not closer.is_alive(), "a caller was stranded by close()"
    assert isinstance(err["e"], RuntimeError)
    with pytest.raises(RuntimeError, match="closed"):
        b(p._forward, _random_windows(p, 1, seed=7))


def test_served_stream_from_artifact_matches_offline(ckpt, wave, tmp_path):
    """The daemon serves an artifact-backed predictor with --batch-streams,
    bit-equal to the offline artifact predictor and to the checkpoint's."""
    out = export_serving(ckpt, tmp_path / "a.pt2", batch_windows=4, device="cpu")
    p = SELDPredictor.from_artifact(out, device="cpu")
    s, t = _serve(p, max_streams=1, batch_streams=True)
    classes, _ = _client(s.port, _chunks(wave))
    t.join(timeout=WAIT)
    s.server_close()
    assert not t.is_alive()
    np.testing.assert_array_equal(classes, p.predict_waveform(wave).classes)
    ckpt_ref = SELDPredictor(ckpt, batch_windows=4, device="cpu").predict_waveform(wave)
    np.testing.assert_array_equal(classes, ckpt_ref.classes)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_serve_logs_its_port_and_exits_after_max_streams(ckpt, wave, caplog):
    """`cli serve --port 0 --max-streams 1` names its port in the "Serving
    ... on host:port" line and returns 0 after one stream."""
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", port_main([
        "serve", "--checkpoint", str(ckpt), "--port", "0", "--max-streams", "1",
        "--batch-streams", "--device", "cpu"])))
    with caplog.at_level(logging.INFO, logger="seld_tpu_torch"):
        t.start()
        port = None
        for _ in range(WAIT * 20):
            found = [re.search(r"Serving conformer on 127\.0\.0\.1:(\d+)", r.getMessage())
                     for r in caplog.records]
            port = next((int(m.group(1)) for m in found if m), None)
            if port or not t.is_alive():
                break
            time.sleep(0.05)
        assert port, "no Serving line"
        classes, _ = _client(port, _chunks(wave))
        t.join(timeout=WAIT)
    assert not t.is_alive() and rc["rc"] == 0
    ref = SELDPredictor(ckpt, batch_windows=8, device="cpu").predict_waveform(wave)
    np.testing.assert_array_equal(classes, ref.classes)


# --- against the JAX package -----------------------------------------------------------


def test_jax_client_drives_the_port_server(server, wave):
    """seld_tpu's stream_client speaks the port's protocol: the same classes
    as the port's own client, plain and overlapped."""
    for overlap in (0.0, 0.5):
        ours, info = _client(server.port, _chunks(wave), overlap=overlap)
        theirs, jax_info = jax_stream_client("127.0.0.1", server.port, _chunks(wave),
                                             overlap=overlap)
        np.testing.assert_array_equal(theirs, ours)
        assert jax_info == info == {"done": True, "total_samples": wave.shape[1]}


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_jax")
    jax_ckpt, port_path = jax_and_port_checkpoints(
        tmp, ["model.model_type=conformer", *TINY[:5]], batch=2)
    yield JaxPredictor(jax_ckpt, batch_windows=2), port_path
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("batch_streams", [False, True], ids=["solo", "batched"])
def test_served_stream_matches_jax_offline(jax_and_port, wave, batch_streams):
    """The same weights in both packages: the port's served stream makes
    JAX's offline decisions outside the margin band of the two float32
    forwards."""
    jax_pred, port_path = jax_and_port
    port = SELDPredictor(port_path, batch_windows=2, device="cpu")
    s, t = _serve(port, batch_streams=batch_streams)
    try:
        classes, _ = _client(s.port, _chunks(wave, 7000))
    finally:
        _close(s, t)
    np.testing.assert_array_equal(classes, port.predict_waveform(wave).classes)
    _assert_same_decisions(jax_pred.predict_waveform(wave).classes, classes,
                           _logit_margin(port, wave))


@pytest.mark.parametrize("model_type", ["conformer", "crnn", "resnet_conformer"])
def test_batch_rows_do_not_depend_on_their_slot(model_type):
    """What lets the batcher pack freely: a batch's rows permuted give the
    permuted outputs bit for bit, and a row among zeros gives what it gives
    among other windows."""
    over = [f"model.model_type={model_type}", "model.resnet_conf_d_model=16",
            "model.resnet_conf_n_heads=2", "model.resnet_conf_n_layers=1"]
    cfg = pc.parse_overrides(pc.Config(), [*TINY, *over])
    model = build_model(cfg.model, cfg.grid, device="cpu", seed=3, in_channels=4)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (8, cfg.window.window_frames(cfg.features), 4, 64)).astype(np.float32))
    perm = torch.tensor([5, 2, 7, 0, 3, 6, 1, 4])
    with torch.inference_mode():
        base = model(x)
        assert torch.equal(model(x[perm]), base[perm])
        alone = torch.zeros_like(x)
        alone[6] = x[2]
        assert torch.equal(model(alone)[6], base[2])
