#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seld_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the device: its name, and name and power limit from nvidia-smi;
  2. build every CUDA kernel from seld_tpu_torch/csrc into build/kernels;
  3. kernel K1 against its plain PyTorch version on the card, in float32,
     at the main path's shape (a 60 s 4-channel clip, N = 12,004 frames),
     at a ragged N = 37 and on silence; times of the kernel, the plain
     version and a torch.stft + matmul + log10 chain, and K1's bound;
  4. the flagship ResNet50-Conformer (default Config: d_model 512, 8 heads,
     4 blocks, 250-frame windows, bf16) from seeded weights, saved and
     loaded through seld_tpu_torch.train.checkpoint, serving a seeded 60 s
     clip through SELDPredictor.predict_waveform; K1's launch count is
     reset just before that call and read just after it. Then timed
     predicts, and one more under torch.profiler for the device's busy
     share and the kernel time by kernel family;
  5. the model in true float32 (TF32 off) on the card against the CPU on
     one window with the same weights.
It prints one JSON line of kernel figures, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from seld_tpu_torch import no_tf32

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks from NVIDIA's data sheet, at the 700 W power limit
F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
K1_TOL_DB = 5e-3  # float32 DFT-as-GEMM against float32 GEMMs / rFFT
F32_LOGIT_TOL = 1e-3  # card vs CPU float32, sums in other orders
CLIP_SECONDS = 60
# kernel-name patterns -> family for the profile of one predict, first match wins
FAMILIES = (
    ("K1 log-mel", r"log_mel_kernel"),
    ("memcpy / memset", r"memcpy|memset"),
    ("BatchNorm / LayerNorm", r"batch_norm|layer_norm|welford|bn_fw"),
    ("NCHW <-> NHWC transform", r"nchwToNhwc|nhwcToNchw"),
    ("convolution", r"conv|implicit|dgrad|wgrad|fprop|sm90_xmma|cudnn|winograd"),
    ("GEMM", r"gemm|cutlass|cublas|nvjet|sm90_"),
    ("softmax / reduction", r"softmax|reduce|max_|argmax"),
    ("copy / cast / elementwise", r"elementwise|copy|cat|fill|vectorized|unrolled"),
)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} visible")
    return name, smi


def phase_build() -> None:
    from seld_tpu_torch.ops import _build

    for src in sorted(_build.CSRC.glob("*.cu")):
        info = _build.build(src.stem)
        if info is None:
            print(f"[build] {src.stem}: built already ({_build.library_path(src.stem).name})")
            continue
        print(f"[build] {src.stem}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


def library_log_mel(frames: torch.Tensor, window: torch.Tensor,
                    fb: torch.Tensor) -> torch.Tensor:
    """The same function as K1 from PyTorch's own calls: each frame is one
    hop of a center=False STFT of the concatenated frames."""
    n_fft = frames.shape[1]
    spec = torch.stft(frames.reshape(-1), n_fft=n_fft, hop_length=n_fft,
                      window=window, center=False, return_complex=True)
    power = spec.real.square() + spec.imag.square()  # (bins, N)
    return 10.0 * torch.log10(torch.clamp_min(power.T @ fb, 1e-10))


def k1_bound(n: int, n_fft: int, fb: torch.Tensor) -> dict:
    """The least card time for K1's function on n frames; fb is the
    (n_fft // 2 + 1, n_mels) filterbank of this run.

    Bytes: the frames and the filterbank read once, the log-mel written
    once. Operations: the least arithmetic that computes the function: the
    Hann window (n_fft multiplies), a real FFT (2.5 n_fft log2 n_fft, the
    usual count), the power (3 per bin), the filterbank product over its
    nonzero entries (2 each) and the dB (3 per mel). K1 itself computes the
    DFT as GEMMs; `gemm_ms` is the float32 floor of that arithmetic at the
    real bins and mels, without the kernel's zero padding."""
    n_freqs, n_mels = fb.shape
    nnz = int((fb != 0).sum())
    n_bytes = 4 * (n * n_fft + fb.numel() + n * n_mels)
    ops = n * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_freqs + 2 * nnz + 3 * n_mels)
    gemm_flops = 2 * n * n_fft * 2 * n_freqs + 2 * n * n_freqs * n_mels
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "ops": ops,
        "gemm_flops": gemm_flops, "gemm_ms": gemm_flops / F32_FLOPS * 1e3,
    }


def phase_k1(dev: torch.device) -> dict:
    from seld_tpu_torch.config import FeatureConfig, ModelConfig
    from seld_tpu_torch.features.mel import hann_window, mel_filterbank
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames, log_mel_frames_reference

    feat = FeatureConfig()
    n_fft, n_mels = feat.n_fft, feat.n_mels
    # the main path's frame count: 4 channels x (1 + 60 s * 50 frames/s)
    n = ModelConfig().n_channels * (1 + CLIP_SECONDS * feat.sample_rate // feat.hop_length)
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((n, n_fft), generator=g, device=dev)

    got = log_mel_frames(frames)
    torch.cuda.synchronize()
    want = log_mel_frames_reference(frames)
    err = (got - want).abs().max().item()
    window = torch.from_numpy(hann_window(n_fft)).to(dev)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, feat.sample_rate)).to(dev)
    lib_err = (got - library_log_mel(frames, window, fb)).abs().max().item()
    print(f"[K1] N={n}: max |kernel - plain| {err:.3e} dB, "
          f"max |kernel - stft chain| {lib_err:.3e} dB (tolerance {K1_TOL_DB})")
    if not (err <= K1_TOL_DB and lib_err <= K1_TOL_DB):
        raise AssertionError(f"K1 disagrees: {err} / {lib_err} dB")

    ragged = torch.randn((37, n_fft), generator=g, device=dev)
    r_err = (log_mel_frames(ragged) - log_mel_frames_reference(ragged)).abs().max().item()
    silence = log_mel_frames(torch.zeros((8, n_fft), device=dev))
    s_err = (silence + 100.0).abs().max().item()
    torch.cuda.synchronize()
    print(f"[K1] N=37: max |kernel - plain| {r_err:.3e} dB; silence: max |out + 100| {s_err:.3e} dB")
    if not (r_err <= K1_TOL_DB and s_err <= 1e-4):
        raise AssertionError(f"K1 ragged/silence check failed: {r_err} / {s_err}")

    k1_ms = cuda_ms(lambda: log_mel_frames(frames))
    plain_ms = cuda_ms(lambda: log_mel_frames_reference(frames))
    library_ms = cuda_ms(lambda: library_log_mel(frames, window, fb))
    b = k1_bound(n, n_fft, fb)
    print(f"[K1] kernel {k1_ms:.4f} ms, plain {plain_ms:.4f} ms, stft chain "
          f"{library_ms:.4f} ms")
    print(f"[K1] bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes'] / 1e6:.2f} MB "
          f"at 3.35 TB/s; {b['ops'] / 1e9:.3f} GFLOP at 67 TFLOP/s f32): kernel at "
          f"{100 * b['bound_ms'] / k1_ms:.2f} % of it")
    print(f"[K1] DFT-as-GEMM arithmetic at the real {fb.shape[0]} bins: "
          f"{b['gemm_flops'] / 1e9:.2f} GFLOP, f32 floor {b['gemm_ms']:.4f} ms; kernel "
          f"{b['gemm_flops'] / (k1_ms * 1e-3) / 1e12:.2f} TFLOP/s "
          f"({100 * b['gemm_ms'] / k1_ms:.1f} % of the f32 peak), plain GEMMs "
          f"{b['gemm_flops'] / (plain_ms * 1e-3) / 1e12:.2f} TFLOP/s")
    return {
        "name": "K1", "route": "cuda",
        "source": "seld_tpu_torch/csrc/mel_kernel.cu",
        "replaces": "seld_tpu/ops/mel_pallas.py:77",
        "launches": None, "max_abs_err": err, "ms": k1_ms, "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": library_ms,
    }


def phase_flagship(dev: torch.device) -> int:
    from seld_tpu_torch.config import Config
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    cfg = Config()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        model = build_model(cfg.model, cfg.grid, device=dev, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        save_checkpoint(Path(tmp) / "flagship.pt", model, cfg)
        del model
        pred = SELDPredictor(Path(tmp) / "flagship.pt", batch_windows=8, device=dev)
    sr = cfg.features.sample_rate
    wave = (0.1 * np.random.default_rng(0).standard_normal((4, CLIP_SECONDS * sr))
            ).astype(np.float32)
    pred.predict_waveform(wave)  # warm-up: cuDNN plans, K1 constants
    torch.cuda.synchronize()

    log_mel_frames.launches = 0
    t0 = time.perf_counter()
    out = pred.predict_waveform(wave)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = log_mel_frames.launches
    if launches < 1:
        raise AssertionError("the main path did not launch K1")

    t_frames = 1 + CLIP_SECONDS * sr // cfg.features.hop_length
    classes = out.classes
    if classes.shape != (t_frames, cfg.grid.n_cells):
        raise AssertionError(f"class grid shape {classes.shape}")
    if classes.min() < 0 or classes.max() >= cfg.grid.num_classes:
        raise AssertionError(f"classes outside [0, {cfg.grid.num_classes - 1}]")

    from seld_tpu_torch.data.corpus import compute_mel_features

    mel = compute_mel_features(wave, cfg.features, dev)
    n_win = mel.shape[0] // pred.win
    windows = mel[: n_win * pred.win].reshape(n_win, pred.win, *mel.shape[1:])
    for start in range(0, n_win, pred.batch_windows):
        logits = pred._raw_apply(windows[start:start + pred.batch_windows])
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
    batch = windows[: pred.batch_windows]
    forward_ms = cuda_ms(lambda: pred._raw_apply(batch), iters=10)

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict_waveform(wave)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    clip_ms = float(np.median(times))
    print(f"[flagship] {n_params / 1e6:.2f} M parameters, bf16; {CLIP_SECONDS} s clip -> "
          f"classes {classes.shape}, {int((classes != cfg.grid.background_class).sum())} "
          f"active cells; K1 launches {launches}")
    print(f"[flagship] predict_waveform: {clip_ms:.2f} ms per {CLIP_SECONDS} s clip "
          f"(median of {', '.join(f'{t:.2f}' for t in times)}; counted run {first_ms:.2f} ms) = "
          f"{CLIP_SECONDS / (clip_ms * 1e-3):.1f} audio-s/s; model forward "
          f"{forward_ms:.3f} ms per batch of {pred.batch_windows} windows")
    profile_predict(pred, wave, clip_ms)
    return launches


def profile_predict(pred, wave: np.ndarray, clip_ms: float) -> None:
    """One predict under torch.profiler: the device's busy share (kernel
    time over wall time) and the kernel time by family and by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_waveform(wave)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_family, counts = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in kernels:
        fam = next((f for f, pat in FAMILIES if re.search(pat, e.name, re.I)), "other")
        by_name[e.name] += e.device_time_total / 1e3
        by_family[fam] += e.device_time_total / 1e3
        counts[fam] += 1
    busy_ms = sum(by_name.values())
    print(f"[profile] profiled predict {wall_ms:.2f} ms wall; {len(kernels)} kernel launches, "
          f"{busy_ms:.2f} ms of kernel time: device busy {100 * busy_ms / wall_ms:.1f} % of the "
          f"profiled predict, {100 * busy_ms / clip_ms:.1f} % of the unprofiled median")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {fam:28s} {ms:8.3f} ms  {counts[fam]:5d} launches")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[profile]   top {ms:8.3f} ms  {name[:100]}")


def phase_f32(dev: torch.device) -> None:
    from seld_tpu_torch.config import Config, ModelConfig
    from seld_tpu_torch.data.corpus import compute_mel_features
    from seld_tpu_torch.models import build_model

    cfg = Config(model=ModelConfig(compute_dtype="float32"))
    on_card = build_model(cfg.model, cfg.grid, device=dev, seed=1)
    on_cpu = build_model(cfg.model, cfg.grid, device="cpu", seed=1)
    wave = (0.1 * np.random.default_rng(1).standard_normal((4, 5 * cfg.features.sample_rate))
            ).astype(np.float32)
    win = cfg.window.window_frames(cfg.features)
    x = compute_mel_features(wave, cfg.features, dev)[:win][None].cpu()
    seen = []  # the TF32 switches as the card's forward runs its first convolution
    on_card.encoder.stem.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with torch.inference_mode():
        a = on_card(x.to(dev)).cpu()
        b = on_cpu(x)
    after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if seen != [(False, False)] or after != before:
        raise AssertionError(f"TF32 switches: {seen} inside the forward, {before} -> {after}")
    err = (a - b).abs().max().item()
    print(f"[f32] one {win}-frame window, card vs CPU: max |logit diff| {err:.3e} "
          f"(tolerance {F32_LOGIT_TOL}; logit scale {b.abs().max().item():.3f})")
    if not err <= F32_LOGIT_TOL:
        raise AssertionError(f"float32 card vs CPU logits differ by {err}")


def main() -> int:
    name, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    with no_tf32():  # the plain versions in true float32
        k1 = phase_k1(dev)
    k1["launches"] = phase_flagship(dev)
    phase_f32(dev)
    print(json.dumps({"kernels": [k1]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
