#!/usr/bin/env python3
"""Time the mixed-radix kernels of K1 and K4 (csrc/mixed_fft.cuh) from two
source trees in turns on one NVIDIA card.

    python3 scripts/mixed_fft_ab.py BASE_TREE [CHANGE_TREE]

Each tree is a directory holding seld_tpu_torch/csrc (a checkout, or a copy
of that directory alone); CHANGE_TREE defaults to this repository. Both
trees' csrc/mel_kernel.cu and csrc/spatial_kernel.cu are built side by side
into build/ab/lib-<base|change>/ with this repository's nvcc flags, and their
C entries seld_log_mel_frames_mixed / seld_spatial_features_mixed are
called through this repository's wrappers (ops/mel_cuda.py::launch and
ops/spatial_cuda.py::launch, the same tables and arguments), so the two
trees must share those entries' C interface. At n_fft 1200 and 600 it
checks that both trees' outputs agree with the plain versions, then times
K1 on 12,004 contiguous frames and K4 "mel_iv" and "mel_gcc" on
frame_signal's in-place (4, 3001, n_fft) view of a seeded 60 s clip, each
a mean of 20 launches queued behind a device spin (chip_smoke.kernel_ms),
in turns base, change, change, base, for --rounds rounds. Prints the card
and its power limit, one line per shape, and a JSON line of every reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import K1_TOL_DB, k4_check, k4_errors, kernel_ms  # noqa: E402
from seld_tpu_torch import no_tf32  # noqa: E402
from seld_tpu_torch.features.mel import frame_signal  # noqa: E402
from seld_tpu_torch.ops import _build, mel_cuda, spatial_cuda  # noqa: E402

SOURCES = {"mel_kernel": ("seld_log_mel_frames_mixed",),
           "spatial_kernel": ("seld_spatial_features_mixed",)}
N_FFT = (1200, 600)


def build(tree: Path, label: str) -> dict:
    """Each source of `tree` built into build/ab/lib-<label>/; its entries bound
    with this repository's argument types."""
    csrc = tree / "seld_tpu_torch" / "csrc"
    out = ROOT / "build" / "ab" / f"lib-{label}"
    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        lib = out / f"{name}.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                              str(lib), str(csrc / f"{name}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label} {name}:\n{res.stdout}")
        return name, lib

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(one, SOURCES))
    entries = {}
    for name, lib in built:
        handle = ctypes.CDLL(str(lib))
        wrapper = mel_cuda if name == "mel_kernel" else spatial_cuda
        for entry in SOURCES[name]:
            fn = getattr(handle, entry)
            fn.argtypes = wrapper._ARGTYPES[entry]
            fn.restype = ctypes.c_int
            entries[entry] = fn
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("change", type=Path, nargs="?", default=ROOT)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    libs = {"base": build(args.base, "base"), "change": build(args.change, "change")}
    wrapped = {wrapper: wrapper._entry for wrapper in (mel_cuda, spatial_cuda)}

    def on(label):
        for wrapper in wrapped:
            wrapper._entry = lambda entry, label=label: libs[label][entry]

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    wave = 0.1 * torch.randn((4, 60 * 24_000), generator=g, device=dev)
    readings = {}
    try:
        with no_tf32():
            for nf in N_FFT:
                frames = torch.randn((12_004, nf), generator=g, device=dev)
                view = frame_signal(wave, nf, 480)
                copy = view.contiguous()
                runs = {"K1": lambda: mel_cuda.launch("mixed", frames, nf),
                        **{f"K4 {fs}": (lambda fs=fs: spatial_cuda.launch("mixed", view, fs))
                           for fs in ("mel_iv", "mel_gcc")}}
                outs = {}
                for label in libs:
                    on(label)
                    outs[label] = {name: fn() for name, fn in runs.items()}
                    err = (outs[label]["K1"] - mel_cuda.log_mel_frames_reference(frames)
                           ).abs().max().item()
                    if not err <= K1_TOL_DB:
                        raise AssertionError(f"{label} K1 n_fft={nf}: {err} dB")
                    for fs in ("mel_iv", "mel_gcc"):
                        k4_check(f"{label} n_fft={nf} {fs}", k4_errors(
                            outs[label][f"K4 {fs}"],
                            spatial_cuda.spatial_features_reference(copy, fs)))
                same = [name for name in runs
                        if torch.equal(outs["base"][name], outs["change"][name])]
                print(f"[ab] n_fft={nf}: both trees match the plain versions; bit-equal "
                      f"between the trees: {', '.join(same) or 'none'}")
                for name, fn in runs.items():
                    times = {"base": [], "change": []}
                    for _ in range(args.rounds):
                        for label in ("base", "change", "change", "base"):
                            on(label)
                            times[label].append(kernel_ms(fn))
                    readings[f"{name} n_fft={nf}"] = times
                    print(f"[ab] {name} n_fft={nf}: base median "
                          f"{np.median(times['base']):.4f} ms, change median "
                          f"{np.median(times['change']):.4f} ms; change wins "
                          f"{sum(c < b for b, c in zip(times['base'], times['change']))} of "
                          f"{len(times['base'])} pairs")
    finally:
        for wrapper, entry in wrapped.items():
            wrapper._entry = entry
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
