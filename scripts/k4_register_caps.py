"""Kernel K4 (csrc/spatial_kernel.cu) built with a minimum-blocks hint in
its launch bounds, against the kept build, on one NVIDIA card.

    python3 scripts/k4_register_caps.py [--rounds 3]

The kept kernel is declared __launch_bounds__(128) and the compiler picks
its registers. Each build copies the source into build/exp/: the kept
one as it is, each variant declaring __launch_bounds__(128, B) for B in
MIN_BLOCKS (at most 65,536 / (128 B) registers a thread). All are built
with the port's nvcc flags, all started together. It prints each build's
registers and spills for n_fft = 960 (float2 loads) from ptxas -v, checks
that every variant gives the kept build's output bit for bit, then times
"mel_iv" and "mel_gcc" on frame_signal's in-place (4, 3001, 960) view of
a reflect-padded seeded 60 s clip, every build in turns (reversed each
round) within one process. The last line is one JSON object of the
readings.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import kernel_ms  # noqa: E402
from seld_tpu_torch.features.mel import frame_signal  # noqa: E402
from seld_tpu_torch.ops import _build, spatial_cuda  # noqa: E402

MIN_BLOCKS = (1, 2, 4, 6, 8)
SETS = ("mel_iv", "mel_gcc")
BOUNDS = "__launch_bounds__(kThreads)"


def build_variant(blocks: int | None) -> tuple[Path, str]:
    """The source with a minimum of `blocks` blocks an SM in its launch
    bounds (None: as it is), built; its library and ptxas's log."""
    src = (_build.CSRC / "spatial_kernel.cu").read_text()
    if src.count(BOUNDS) != 1:
        raise AssertionError(f"expected one {BOUNDS} in spatial_kernel.cu")
    out = ROOT / "build" / "exp" / f"spatial_kernel_b{blocks or 0}"
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = out.with_suffix(".cu")
    if blocks is not None:
        src = src.replace(BOUNDS, f"__launch_bounds__(kThreads, {blocks})")
    cu.write_text(src)
    lib = out.with_suffix(".so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                          "-o", str(lib), str(cu)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for min blocks {blocks}:\n{res.stdout}")
    return lib, res.stdout


def resources(log: str) -> dict[str, dict]:
    """Registers and spilled bytes of the n_fft = 960 float2-load
    instantiations, by feature set, from ptxas -v."""
    found, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"spatial_kernelILi15ELi(\d)ELb1E", line)
            entry = ("mel", "mel_iv", "mel_gcc")[int(m.group(1))] if m else None
        elif entry and "spill" in line:
            found.setdefault(entry, {})["spill"] = sum(
                int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif entry and "registers" in line:
            found.setdefault(entry, {})["regs"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return found


def bind(lib: Path):
    fn = ctypes.CDLL(str(lib)).seld_spatial_features
    fn.argtypes = spatial_cuda._ARGTYPES["seld_spatial_features"]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)

    with ThreadPoolExecutor(1 + len(MIN_BLOCKS)) as pool:
        built = list(pool.map(build_variant, (None, *MIN_BLOCKS)))
    names = ["kept"] + [f"min blocks {b}" for b in MIN_BLOCKS]
    kernels, res = {}, {}
    for name, (lib, log) in zip(names, built):
        kernels[name] = bind(lib)
        res[name] = resources(log)
    for name in names:
        print(f"[build] {name}: " + "; ".join(
            f"{fs} {r.get('regs')} registers, {r.get('spill', 0)} bytes spilled"
            for fs, r in sorted(res[name].items())))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    wave = 0.1 * torch.randn((4, 60 * 24_000), generator=g, device=dev)
    view = frame_signal(wave, 960, 480)
    wrapper_fn = spatial_cuda._entry

    def run(name, fs):
        spatial_cuda._entry = lambda entry: kernels[name]
        try:
            return spatial_cuda.spatial_features(view, fs)
        finally:
            spatial_cuda._entry = wrapper_fn

    for fs in SETS:
        want = run("kept", fs)
        for name in names[1:]:
            if not torch.equal(run(name, fs), want):
                raise AssertionError(f"{name} {fs}: not the kept build's output")
    print("[check] every variant gives the kept build's output bit for bit")

    times = {n: {fs: [] for fs in SETS} for n in names}
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            for fs in SETS:
                times[name][fs].append(kernel_ms(lambda: run(name, fs)))
    for name in names:
        print(f"[time] {name}: " + "; ".join(
            f"{fs} " + " / ".join(f"{t:.4f}" for t in times[name][fs]) + " ms" for fs in SETS))
    print(json.dumps({"card": smi, "view": list(view.shape), "resources_n_fft_960": res,
                      "ms_in_place": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
