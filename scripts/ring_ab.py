#!/usr/bin/env python3
"""Time kernel K5 (ring attention) of two trees of this repository in turns
on one NVIDIA card.

    python3 scripts/ring_ab.py PARENT_TREE [CHANGE_TREE]

Each tree is a checkout of the repository (for example one unpacked from
`git archive`), with its own seld_tpu_torch and its own build directory;
CHANGE_TREE defaults to the tree this script is in. Both trees' K3 library
(csrc/flash_attention_kernel.cu, which K5 launches) is built first, side
by side; then each tree is timed in a process of its own, in turns:
parent, change, change, parent. A run times, at K3's main-path shape (B 16,
H 8, T 1000, Dh 64, q/k/v strided as the model makes them) in bf16 and
float32, the virtual ring at n = 4 ranks: forward and backward device ms
(CUDA events over 20 calls queued behind a spin longer than the host needs
to queue them), host µs per call (no synchronize between calls), and the
kernels of one profiled call (count and summed device time); and, in bf16,
the device ms and host µs of one K3 launch_forward, launch_dq and
launch_dkv over the whole T (the kernels K5 runs per chunk). Each run
prints one JSON line; the last line holds each tree's two readings of
every measurement. Only the
public entry points are called (virtual_ring_attention /
virtual_ring_backward and K3's launch functions), which both trees have.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

N_RANKS = 4
B, H, T, DH = 16, 8, 1000, 64
ITERS = 20


def _env(tree: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tree)
    return env


def _device_ms(fn, host_us_per_call: float) -> float:
    """Mean device time of fn() over ITERS calls by CUDA events, the calls
    queued behind a spin of at least three times their host time, so the
    events time the device alone."""
    import torch

    for _ in range(3):
        fn()
    spin_s = max(25e-3, 3 * host_us_per_call * 1e-6 * ITERS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(spin_s * torch.cuda.get_device_properties(0).clock_rate * 1e3))
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _host_us(fn, calls: int = 50) -> float:
    """Host wall time of one fn() call in µs, no synchronize between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def _profiled(fn) -> dict:
    """The kernels of one fn() call: count, summed device ms, and how many
    are not K3's (flash_*) kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # behind a spin (left out): a session can lose the first events it sees
        torch.cuda._sleep(int(5e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3))
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation and "spin_kernel" not in e.name]
    return {"kernels": len(events),
            "other_kernels": sum("flash_" not in e.name for e in events),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in events) / 1e3}


def time_this_tree() -> dict:
    """The measurements of the tree on PYTHONPATH (see the module note)."""
    import torch

    from seld_tpu_torch.ops import flash_attention as k3
    from seld_tpu_torch.ops.ring_attention import virtual_ring_attention, virtual_ring_backward

    dev = torch.device("cuda")
    out = {"tree": str(Path(k3.__file__).resolve().parents[2]),
           "device": torch.cuda.get_device_name(0)}
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "float32")):
        gen = torch.Generator(device=dev).manual_seed(21)
        q, k, v, w = (torch.randn((B, T, H * DH), generator=gen, device=dev).to(dtype)
                      .view(B, T, H, DH).transpose(1, 2) for _ in range(4))
        qs, ks, vs, ws = (list(x.chunk(N_RANKS, dim=2)) for x in (q, k, v, w))
        with torch.no_grad():
            outs, lses = virtual_ring_attention(qs, ks, vs)

            def fwd():
                return virtual_ring_attention(qs, ks, vs)

            def bwd():
                return virtual_ring_backward(qs, ks, vs, ws, outs, lses)

            for part, fn in (("fwd", fwd), ("bwd", bwd)):
                host = _host_us(fn)
                out[f"{kind} {part}"] = {"ms": _device_ms(fn, host), "host_us": host,
                                         **_profiled(fn)}
            if dtype == torch.bfloat16:
                scale = DH ** -0.5
                whole_out, lse = k3.launch_forward(q, k, v, scale)
                _, delta = k3.launch_dq(q, k, v, w, whole_out, lse, scale)
                launches = {
                    "fwd": lambda: k3.launch_forward(q, k, v, scale),
                    "dq": lambda: k3.launch_dq(q, k, v, w, whole_out, lse, scale),
                    "dkv": lambda: k3.launch_dkv(q, k, v, w, lse, delta, scale)}
                out["K3 host_us"] = {name: _host_us(fn, 200) for name, fn in launches.items()}
                out["K3 ms"] = {name: _device_ms(fn, out["K3 host_us"][name])
                                for name, fn in launches.items()}
        del q, k, v, w, qs, ks, vs, ws, outs, lses
        torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--time"]:
        print("[ring-ab] " + json.dumps(time_this_tree()), flush=True)
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(argv[0]).resolve()
    change = Path(argv[1]).resolve() if len(argv) > 1 else Path(__file__).resolve().parents[1]
    trees = {"parent": parent, "change": change}
    build = "from seld_tpu_torch.ops import _build; _build.build('flash_attention_kernel')"
    builds = {name: subprocess.Popen([sys.executable, "-c", build], cwd=tree, env=_env(tree))
              for name, tree in trees.items()}  # one nvcc each, side by side
    for name, proc in builds.items():
        if proc.wait(timeout=600) != 0:
            raise RuntimeError(f"building K3 in the {name} tree failed")
    runs = []
    for name in ("parent", "change", "change", "parent"):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time"],
                             cwd=trees[name], env=_env(trees[name]), capture_output=True,
                             text=True, timeout=600)
        lines = [x for x in res.stdout.splitlines() if x.startswith("[ring-ab] ")]
        if res.returncode != 0 or len(lines) != 1:
            raise RuntimeError(f"timing the {name} tree failed:\n{res.stdout[-2000:]}\n"
                               f"{res.stderr[-4000:]}")
        record = json.loads(lines[0].split(" ", 1)[1])
        record["side"] = name
        runs.append(record)
        print(f"[ring-ab] {name}: " + json.dumps(record), flush=True)
    summary = {}
    for name in trees:
        mine = [r for r in runs if r["side"] == name]
        for key in mine[0]:
            if isinstance(mine[0][key], dict):
                summary[f"{name} {key}"] = {
                    m: [r[key][m] for r in mine] for m in mine[0][key]}
    print(json.dumps({"ring_ab": summary, "device": runs[0]["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
