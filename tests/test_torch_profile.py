"""train.profile_steps and seld_tpu_torch.tools.profile_summary on the CPU:
a tiny CRNN trained with a torch.profiler trace of steps 1-2 writes one
Chrome-trace JSON under <output>/profile and trains bit for bit as the
same run without it; the trace's window when the first epoch is short and
when training ends first; the summary tool on that trace (the host's CPU
ops: it has no device events) and on a hand-written trace with CUDA
kernels of two devices, memcpy, memset and NCCL events, whose rows,
categories and busy time are known exactly."""

import contextlib
import io
import json
import logging
import shutil

import pytest

from seld_tpu_torch import config as pc
from seld_tpu_torch.data.synthetic import synthetic_corpus
from seld_tpu_torch.tools import profile_summary as ps
from seld_tpu_torch.train.trainer import train_model
from tests.test_torch_model import one_torch_thread  # noqa: F401 (autouse)

TINY = ["model.model_type=crnn", "model.crnn_cnn_channels=8,16", "model.crnn_rnn_hidden=16",
        "model.crnn_rnn_layers=1", "model.compute_dtype=float32", "window.window_seconds=1.0",
        "window.hop_seconds=0.5", "train.batch_size=2", "train.num_epochs=2",
        "train.save_every_n_epochs=1"]


def _train(base, *extra):
    """(history, metrics.jsonl records without their seconds, log messages)
    of a tiny CRNN run under base: 3 train steps an epoch."""
    cfg = pc.parse_overrides(pc.Config(), [*TINY, f"data.base_path={base}", *extra])
    train_c = synthetic_corpus(cfg, n_files=1, seconds=3.0, seed=0, device="cpu")
    test_c = synthetic_corpus(cfg, n_files=1, seconds=2.0, seed=1, train=False, device="cpu")
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    log = logging.getLogger("seld_tpu_torch.train.trainer")
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        _, history = train_model(cfg, train_c, test_c, device="cpu")
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    records = [json.loads(line) for line in
               (base / "checkpoints" / "metrics.jsonl").read_text().splitlines()]
    for r in records:
        r.pop("seconds")
    return history, records, messages


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tiny run with train.profile_steps=2 and without it."""
    base = tmp_path_factory.mktemp("profile_runs")
    plain = _train(base / "plain")
    traced = _train(base / "traced", "train.profile_steps=2")
    yield plain, traced, base / "traced"
    shutil.rmtree(base, ignore_errors=True)


def test_profiled_run_trains_bit_for_bit_and_writes_one_trace(runs):
    (plain_hist, plain_rec, _), (hist, rec, messages), base = runs
    assert rec == plain_rec
    assert hist["train_losses"] == plain_hist["train_losses"]
    assert hist["test_losses"] == plain_hist["test_losses"]
    (trace,) = (base / "outputs" / "profile").iterdir()
    assert trace.name.endswith("_rank0.pt.trace.json")
    assert ps.find_trace(base / "outputs" / "profile") == str(trace)
    assert [m for m in messages if m.startswith("profiler trace")] == [
        f"profiler trace started -> {base / 'outputs' / 'profile'}",
        f"profiler trace captured (2 steps) -> {trace}"]


def test_summary_of_the_cpu_trace(runs):
    *_, base = runs
    trace_dir = base / "outputs" / "profile"
    rows, plane = ps.summarize(trace_dir, top=10)
    assert plane == ps.HOST_PLANE  # no device events on the CPU
    assert 0 < len(rows) <= 10
    assert [r[0] for r in rows] == sorted((r[0] for r in rows), reverse=True)
    events = json.loads(open(ps.find_trace(trace_dir)).read())["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    by_name = {}
    for e in ops:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    total = sum(by_name.values())
    assert rows[0][2] == max(by_name, key=by_name.get)
    assert rows[0][0] == pytest.approx(by_name[rows[0][2]] / 1e3)
    assert rows[0][1] == pytest.approx(by_name[rows[0][2]] / total)
    assert any("addmm" in name or "conv" in name or "gru" in name for _, _, name in rows)
    cats = ps.category_totals(trace_dir)
    assert cats["total_ms"] == pytest.approx(total / 1e3)
    assert sum(v for k, v in cats.items()
               if k not in ("total_ms", "enclosing_ms")) == pytest.approx(cats["total_ms"])
    assert 0 < cats["enclosing_ms"] <= cats["total_ms"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert ps.main([str(trace_dir), "--top", "3"]) == 0
    lines = printed.getvalue().splitlines()
    assert lines[0] == f"plane: {ps.HOST_PLANE}" and len(lines) == 5


def test_short_first_epoch_traces_into_the_next_and_the_end_writes_it(tmp_path):
    """profile_steps=4 with 3 steps an epoch: the window runs from step 1 of
    epoch 1 to step 4 of epoch 2, which has 3 steps too, so training ends
    first and the trace is written then (the JAX package loses it), with a
    warning; one epoch with profile_steps=1 stops after its step 1."""
    _, _, messages = _train(tmp_path / "a", "train.profile_steps=4")
    assert ("profiler trace still open when training ended (no later epoch reached step 4): "
            "writing the 5 train steps it holds") in messages
    assert len(list((tmp_path / "a" / "outputs" / "profile").iterdir())) == 1
    _, _, messages = _train(tmp_path / "b", "train.profile_steps=1", "train.num_epochs=1")
    assert any(m.startswith("profiler trace captured (1 steps)") for m in messages)
    shutil.rmtree(tmp_path)


# a torch.profiler Chrome trace by hand: CUDA events of two devices (the
# profiler's pid is the device, args name it too), a host op, a user
# annotation on the device timeline (not device work), and an instant event
K3 = "_Z22flash_fwd_wgmma_kernelILi64EEv14CUtensorMap_stS0_S0_S0_PfPKfiiif"
K2 = "void grid_loss_fwd_kernel<14>(float const*, unsigned short const*, float*, float*, int)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x64x64"
COPY = ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
        "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda(float)#1}>")
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, unsigned int, 3, 64, 64>"
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned long, ncclWork*)"
IDX = "void at::native::index_elementwise_kernel<128, 4>(long, at::native::gpu_index_kernel)"


def _event(cat, name, ts, dur, device=0):
    return {"ph": "X", "cat": cat, "name": name, "pid": device, "tid": 7, "ts": ts, "dur": dur,
            "args": {"device": device, "stream": 7}}


FIXTURE = {"traceEvents": [
    {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "pid": 4242, "tid": 1, "ts": 0,
     "dur": 500.0},
    _event("gpu_user_annotation", "Optimizer.step#Adam.step", 0, 1000.0),
    _event("kernel", K3, 10.0, 100.0),
    _event("kernel", K3, 200.0, 100.0),
    _event("kernel", K2, 290.0, 20.0),  # overlaps the second K3 by 10 µs
    _event("kernel", GEMM, 400.0, 50.0),
    _event("kernel", CONV, 450.0, 30.0),
    _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 500.0, 5.0),
    _event("gpu_memset", "Memset (Device)", 505.0, 1.0),
    _event("kernel", COPY, 600.0, 4.0),
    _event("kernel", CAT, 610.0, 6.0),
    _event("kernel", IDX, 620.0, 2.0),
    _event("kernel", NCCL, 700.0, 40.0),
    _event("kernel", K2, 0.0, 25.0, device=1),  # the other device: less busy
    {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "tid": 7, "ts": 5.0},
]}


def test_summary_of_a_cuda_trace_is_exact(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "p" / "20260101_000000_rank0.pt.trace.json").write_text(json.dumps(FIXTURE))
    rows, plane = ps.summarize(tmp_path / "p", top=4)
    assert plane == "/device:cuda:0"
    total = 200 + 20 + 50 + 30 + 5 + 1 + 4 + 6 + 2 + 40
    assert rows == [(0.2, 200 / total, K3), (0.05, 50 / total, GEMM),
                    (0.04, 40 / total, NCCL), (0.03, 30 / total, CONV)]
    got = ps.category_totals(tmp_path / "p")
    want = {"allreduce_collective_ms": 0.04, "convolution_ms": 0.03, "copy_ms": 0.010,
            "dot_ms": 0.05, "enclosing_ms": 0.348, "fusion_other_ms": 0.22,
            "gather_scatter_ms": 0.002, "slice_concat_ms": 0.006, "total_ms": total / 1e3}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    counts = ps.event_counts(tmp_path / "p")
    assert counts[K3] == 2 and counts[K2] == 1 and sum(counts.values()) == 11
    rows, plane = ps.summarize(tmp_path / "p", plane_filter="cuda:1")
    assert plane == "/device:cuda:1" and rows == [(0.025, 1.0, K2)]
    with pytest.raises(FileNotFoundError, match="no trace"):
        ps.find_trace(tmp_path / "empty")
