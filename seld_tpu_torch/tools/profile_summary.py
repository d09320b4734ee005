"""Profiler trace summary: device time by op from the Chrome-trace JSON
that `train.profile_steps=N` writes, without TensorBoard (counterpart:
seld_tpu/tools/profile_summary.py, which reads a JAX xplane).

How the JAX tool's terms map onto a torch.profiler trace:
  plane         a device: its CUDA kernel, memcpy and memset events,
                grouped by device index ("/device:cuda:N"); the busiest
                one is summarized. A trace with no device events (a CPU
                run) falls back to the host's CPU ops ("/host:CPU"), as
                the JAX tool falls back to the CPU plane without a TPU.
  op name       the event's name: CUDA's kernel name as the profiler
                gives it (demangled or not, template arguments included),
                so every match below is by substring.
  enclosing_ms  the union of the plane's busy intervals: the device's
                wall time spent in the traced work, the nearest meaning to
                the time of JAX's jit_* wrapper events.
  categories    copy: memcpy, memset, copy and cast kernels and layout
                transposes; slice_concat; gather_scatter; convolution:
                cuDNN's fprop, dgrad, wgrad and implicit-GEMM kernels;
                dot: GEMMs (cuBLAS, xmma, CUTLASS, int8 _int_mm);
                allreduce_collective: NCCL and gloo; fusion_other: the
                rest, which takes in the package's own kernels (K1-K4:
                log_mel_kernel, grid_loss_fwd_kernel, flash_fwd_wgmma_kernel,
                ...), as JAX's Pallas custom calls land there.

Host CPU ops nest (an aten::linear holds its aten::addmm), so on the CPU
fallback a name's time includes its children's, as on JAX's CPU plane.

Usage:
  python -m seld_tpu_torch.tools.profile_summary outputs/profile [--top 25]
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

# event categories of device work in torch.profiler's Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_PLANE = "/host:CPU"

#: coarse buckets, matched in order against the lower-cased event name
_CATEGORIES = (
    ("copy", ("memcpy", "memset", "copy_kernel", "nchwtonhwc", "nhwctonchw", "cast_kernel")),
    ("slice_concat", ("catarraybatchedcopy", "concat", "slice", "reflection_pad",
                      "replication_pad", "constant_pad")),
    ("gather_scatter", ("gather", "scatter", "index_select", "indexselect", "index_put",
                        "index_add", "index_elementwise", "indexing_backward", "embedding")),
    ("convolution", ("fprop", "dgrad", "wgrad", "implicit_gemm", "implicit_convolve",
                     "convolve", "winograd")),
    ("dot", ("gemm", "xmma", "cutlass", "_int_mm", "nvjet", "gemv")),
    ("allreduce_collective", ("nccl", "gloo", "allreduce", "all_reduce", "allgather",
                              "all_gather", "reduce_scatter", "reducescatter")),
)


def find_trace(trace_dir) -> str:
    """The newest trace file under trace_dir (names start with their
    timestamp; of one run's ranks, the highest)."""
    files = sorted(str(p) for p in Path(trace_dir).rglob("*.json"))
    if not files:
        raise FileNotFoundError(f"no trace .json under {trace_dir}")
    return files[-1]


def _planes(trace_file) -> dict[str, list[dict]]:
    """{plane name: its complete events}: one plane per device, or the
    host's CPU ops when there is no device event."""
    events = json.loads(Path(trace_file).read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    planes = defaultdict(list)
    for e in complete:
        if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES:
            device = (e.get("args") or {}).get("device", e.get("pid"))
            planes[f"/device:cuda:{device}"].append(e)
    if not planes:
        planes[HOST_PLANE] = [e for e in complete
                              if str(e.get("cat", "")).lower() == "cpu_op"]
    return planes


def _busiest(trace_dir, plane_filter: str | None):
    """(plane name, its events, {name: µs}) of the plane with the most
    event time among those whose name holds plane_filter (default: the
    device planes, else every plane)."""
    planes = _planes(find_trace(trace_dir))
    chosen = {k: v for k, v in planes.items() if (plane_filter or "/device:") in k} or planes
    best = None
    for name, events in chosen.items():
        tot = defaultdict(float)
        for e in events:
            tot[e["name"]] += float(e["dur"])
        if best is None or sum(tot.values()) > sum(best[2].values()):
            best = name, events, tot
    if best is None:
        raise ValueError(f"no events in {find_trace(trace_dir)}")
    return best


def event_counts(trace_dir, plane_filter: str | None = None) -> dict[str, int]:
    """{event name: how many} on the busiest plane: a kernel's launches in
    the traced window."""
    _, events, _ = _busiest(trace_dir, plane_filter)
    counts: dict[str, int] = defaultdict(int)
    for e in events:
        counts[e["name"]] += 1
    return dict(counts)


def summarize(trace_dir, top: int = 25, plane_filter: str | None = None):
    """-> ([(duration_ms, share, op_name)] largest first, at most `top`
    rows, the plane's name), over the busiest plane."""
    plane, _, tot = _busiest(trace_dir, plane_filter)
    total = sum(tot.values())
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [(us / 1e3, us / total if total else 0.0, name) for name, us in rows], plane


def category_totals(trace_dir, plane_filter: str | None = None) -> dict:
    """The busiest plane's time in coarse categories: {"total_ms",
    "enclosing_ms", <category>_ms ..., "fusion_other_ms"} (a category
    appears when it has events). total_ms is the sum of the events' times,
    which the categories partition; enclosing_ms the union of their
    intervals (see the module's docstring)."""
    _, events, tot = _busiest(trace_dir, plane_filter)
    out = defaultdict(float)
    for name, us in tot.items():
        low = name.lower()
        for cat, keys in _CATEGORIES:
            if any(k in low for k in keys):
                out[cat] += us
                break
        else:
            out["fusion_other"] += us
    out["total"] = sum(tot.values())
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    out["enclosing"] = busy
    return {f"{k}_ms": v / 1e3 for k, v in sorted(out.items())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    rows, plane = summarize(args.trace_dir, args.top)
    print(f"plane: {plane}")
    print(f"{'ms':>10}  {'share':>6}  op")
    for ms, share, name in rows:
        print(f"{ms:10.3f}  {share * 100:5.1f}%  {name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
