#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seld_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--phases 1,7,...]

runs every phase below, or with --phases the listed ones, the device and
the build (1, 2) and what a listed phase needs (6 for 14 and 18, 7 for 13);
the last line is the same either way, and the kernels line needs phase 3.
Phases, each of which raises on failure:
  1. the device: its name, and name and power limit from nvidia-smi; `cli
     info`'s JSON: platform "gpu", one device of that name, the config
     equal to Config()'s;
  2. build every CUDA kernel from seld_tpu_torch/csrc into build/kernels,
     one nvcc per source, all started together; K3's wgmma kernels
     (forward, dQ, dK/dV) must not spill at any width, and where cuobjdump
     exists their SASS must hold HGMMA (wgmma) instructions; K4's
     registers, spills and shared memory for every n_fft and feature set,
     none of its instantiations spilling;
  3. kernel K1 against its plain PyTorch version on the card, in float32,
     at the main path's frame count (a 60 s 4-channel clip, N = 12,004
     frames), at a ragged N = 37, on silence, on the main path's input
     (frame_signal's (4, 3001, 960) view of a reflect-padded seeded 60 s
     clip, read in place: one launch), at every n_fft the kernel takes and
     at 40 mels; times of the kernel, the plain version and a torch.stft +
     matmul + log10 chain, in turns, on contiguous frames and in place,
     and K1's bound both ways;
     kernel K2 (grid loss, forward and backward) against its plain version
     at one train batch's N = 4,000 rows (M = 14, G = 648), at a ragged
     N = 37, on an all-background mask and on a many-bit mask; times of
     both kernels, the plain version and the unfused eager loss chain, and
     their bytes bounds;
     kernel K3 (flash attention: forward, dQ, dK/dV) against its plain
     version for out, lse, dq, dk and dv at one long-window train batch
     (B*H = 128, T = 1000, Dh = 64) in bf16 and float32, at ragged T = 130
     and 513, at T = 64, at Dh = 32 and 128, with keys scaled by 10, always
     on q/k/v strided as the model makes them, two backward runs bit-equal;
     the delta that the bf16 dQ kernel forms against row_delta; times of
     each kernel and of the dQ + dK/dV pair, the plain version and
     F.scaled_dot_product_attention, their operations bounds and rates,
     and the host µs of one launch of each;
     kernel K4 (spatial features) against its plain version for "mel",
     "mel_iv" and "mel_gcc" at a 60 s 4-channel clip (T = 3,001 frames),
     at a ragged T = 37, on silence and on the main path's input
     (frame_signal's (4, 3001, 960) view of a reflect-padded seeded 60 s
     clip, read in place: one launch), at every n_fft it takes and at 40
     mels, and against the rFFT chain of seld_tpu_torch.features.spatial;
     its mel planes against K1 on the same frames; the GCC lag peak of a
     7-sample delay; the ACS commutation (audio-side transform then K4
     against K4 then the feature-side transform) for all 16 transforms;
     bit-equal reruns; times of the kernel, the plain version and the rFFT
     chain, in turns, on contiguous frames and in place, and K4's bound
     both ways;
  4. the flagship ResNet50-Conformer (default Config: d_model 512, 8 heads,
     4 blocks, 250-frame windows, bf16) from seeded weights, saved and
     loaded through seld_tpu_torch.train.checkpoint, serving a seeded 60 s
     clip through SELDPredictor.predict_waveform; K1's launch count is
     reset just before that call and read just after it (exactly 1). The
     clip's features hold no framed copy (their peak device memory). Then
     timed predicts, and one more under torch.profiler for the device's
     busy share and the kernel time by kernel family; then the reference
     PyTorch pipeline's checkpoint of those weights (a reference-layout
     .pth that reference_state_dict writes) through `cli import-torch`,
     every imported tensor equal to the weights, and `cli predict` from the
     imported checkpoint of the clip written as a float32 WAV and as an
     EXTENSIBLE float32 WAV: K1 once each, the class grid equal to
     predict_waveform's of the in-memory clip with the weights loaded in
     process, bit for bit; the imported checkpoint's predict timed;
  5. the model in true float32 (TF32 off) on the card against the CPU on
     one window with the same weights, and the TF32 switches held off
     through a float32 train step's forward and backward;
  6. training at full width through `seld_tpu_torch.cli train --synthetic`
     (default Config: flagship, bf16, batch 16, 250-frame windows, two
     epochs): K2's forward and backward launch counts against the steps
     taken, K1's launches while the corpora are built, the artifacts, then
     `--resume` into a third epoch and SELDPredictor serving the best
     checkpoint; then timed train steps and one under torch.profiler;
  7. long windows at full width (window.window_seconds=20.0, T = 1000, so
     attention runs through K3): SELDPredictor serving the 60 s clip, K3's
     forward count against the forwards taken; `cli train --synthetic` for
     one epoch with train.viz_loss_components_every=1 and
     train.profile_steps=2, K3's three counts at exactly four per step and
     four more forward, read around the loss-component dashboard's eval
     forward; the trace of train steps 1 and 2 read back by
     tools.profile_summary ([profile-tool] lines: top rows, categories),
     which must count by kernel name exactly 2 K2 forward, 2 K2 backward
     and 8 each of K3's forward, dQ and dK/dV; `cli eval --synthetic` on
     that run, its JSON report parsed, with its default 5 prediction PNGs
     (K3 forward four more, read around their one forward), each decoded by
     matplotlib and of a frame with events; `[viz]` lines with the
     dashboard's and the visualization pass's forward and rendering times;
     tools.replot of the run's metrics.jsonl. Where matplotlib is not
     installed the dashboard's forward still runs and its rendering logs a
     warning, `cli eval` takes --num-visualizations 0 and replot prints its
     table only; then timed predicts and train steps and one step under
     torch.profiler;
  8. the accuracy recipe at full width (features.feature_set=mel_iv,
     train.acs_augment, targets.use_gaussian_augmentation, 2 + 2
     SpecAugment masks, data.cache_dir) on synthetic WAV files in the
     STARSS22 layout: `cli train` for 2 epochs (K4 launches = clips built,
     K1 launches 0, K2's counts, finite losses, the artifacts, a stored
     cache entry), `cli eval` on the same run (a cache hit: K4 launches 0;
     the trainer's test loss; a DCASE2022 report), SELDPredictor serving
     the 60 s clip from the best checkpoint (K4 once), a seeded "mel_gcc"
     flagship serving it too (K4 once; for both the features' peak device
     memory holds no framed copy), and timed train steps of the recipe
     with both augmentation hooks, one of them profiled.
  9. the other grid backbones at full width (the JAX package's defaults):
     `cli verify` (OK for all six backbones: the flagship, the CSPDarkNet,
     the CRNN, the Conformer and the two ACCDOA families), then for the CRNN, the Conformer and the small
     CSPDarkNet `cli train --synthetic` for one epoch at batch 16 and
     T = 250 (K2's and K1's launch counts exact), a 60 s predict from the
     best checkpoint (K1 once, K3 never; median of five timed calls, peak
     memory), timed train steps and one profiled; the Conformer also a
     60 s predict and timed train steps at 20 s windows, T = 1000 (K3
     forward once per block and forward; forward, dQ and dK/dV once per
     block in a train step);
 10. the flagship's train step at T = 1000 four ways: as it is,
     model.norm_dtype=bfloat16, model.remat=all, both: step ms, kernel
     time by family (the profile lines), peak device memory and K3's
     launches a step (remat recomputes each conformer block: 8 forward
     launches instead of 4).
 11. K1's and K4's kernels at n_fft outside 512 / 960 / 1024 / 2048: the
     mixed-radix kernels (a Stockham FFT in shared memory) at n_fft 1200
     and 600 against their plain versions, contiguous and in place, timed
     in turns against the plain version, the library chain and the DFT
     tiles at the same n_fft; at 640, 882, 1764 and 1920 checked, each
     launch on the mixed-radix counter; the DFT tiles at 1202 checked and
     timed; the register kernels re-timed at their four n_fft; a seeded
     flagship with features.n_fft 1200, 600 and 1202 serving the 60 s clip
     with "mel", "mel_iv" and "mel_gcc" (the mixed-radix kernel once each
     at 1200 and 600, the DFT tiles once at 1202, no other K1 or K4 kernel);
 12. kernel K5 (ring attention) at K3's main-path shape (B*H = 128,
     T = 1000, Dh = 64) in float32 and bf16: the virtual ring (n ranks in
     one process; a step is one launch of K3's forward kernel with the
     merge in its epilogue, and one of its dQ and dK/dV kernels with the
     sums in their stores) at n = 1 (bit-equal to K3), 2 and 4 against K3
     over the whole T and against the plain ring, for out, lse, dq, dk and
     dv, its launches (n x n of each, counted by K5 and by K3) and no
     copies; a profiled n = 4 call (16 kernels forward; 32 backward, dQ
     and dK/dV in turn with nothing between, then at most the 2 n casts of
     dk and dv; each step's µs a launch; run right after phase 3, as a
     profiler session after the later phases' ones can lose device
     events); the host µs of a ring call; ring forward and backward at
     n = 4 timed against K3 over the whole T, the plain ring and
     scaled_dot_product_attention, and the bound (K3's at the whole T);
     where a parent tree is unpacked at build/ab/parent (`git archive`),
     the parent's ring and this one in turns by scripts/ring_ab.py;
 13. sequence parallelism on a 1-rank NCCL group: the ring at n = 1 against
     K3 (bit-equal) and the plain ring (check_bf16); the flagship's first
     T = 1000 train step sharded (K5) and data parallel against the
     unsharded step on the same batch (loss within 1e-5 relative), step
     times in turns and their medians' extra over the unsharded step;
     `torchrun --nproc-per-node
     1 chip_smoke.py --sp-worker train --synthetic ... mesh.enable=on
     mesh.shard_time=true|false` (the CLI under torchrun, then the launch
     counts as JSON): every attention of the sharded run through K5, none
     of the data-parallel run's, epoch losses against phase 7's.
 14. the ACCDOA families at full width (the JAX package's defaults: CNN
     64-512, d_model 256, 4 heads, 2 blocks, 13 classes, bf16) on synthetic
     WAV files in the STARSS22 layout: accdoa_conformer on mel_iv with ACS
     (K4) and multi_accdoa_conformer (3 tracks) on mel (K1), each through
     `cli train` (1 epoch, batch 16, T = 250), `cli eval
     --accdoa-threshold-sweep`, `cli calibrate`, `cli predict --calibration`
     of a seeded 60 s clip and `cli score` of its CSV against the clip's
     ground truth, every step's launches exact (K1 or K4 once per clip
     built or served, K2 never); the device decode of the clip's vectors
     against the host decode (equal but for a vector at a cell edge), two
     runs bit-equal; five timed predicts and timed train steps, one of each
     profiled; multi-ACCDOA at 20 s windows (T = 1000): a 60 s predict (K3
     forward once per block and forward) and timed train steps (forward,
     dQ and dK/dV once per block); then `cli calibrate` of phase 6's
     flagship run (the grid bg_bias path: K2's forward once per eval step
     of each pass) and `cli predict --calibration` (K1 once).
 15. the predictor side of serving on the full-width flagship, seeded
     weights saved as checkpoints: F3, predicts of 100-, 479-, 481- and
     700-sample clips ("mel" and "mel_iv") equal to stream_predict of the
     same clip; the seeded 60 s clip streamed through StreamingSession in
     1 s (predict_file's split), 0.37 s and whole chunks at overlap 0 and
     0.5, the classes bit-equal to the offline predict ([stream] lines),
     K1 ("mel") or K4 ("mel_iv") launches equal to the session's frame
     blocks; offline and streamed predict ms (median of five) and peak
     memory; ACS test-time augmentation on "mel_iv" at T = 250 and
     T = 1000 (window.window_seconds=20.0): identity TTA bit-equal to the
     plain predict, TTA16 at folds 1 and 2 against a float64 host loop
     over _raw_apply of each permuted view (the same decisions outside a
     1e-3 top-2 band), exact launches (K4 once, 16 x batches / fold model
     forwards, K3 forward 4 a forward at T = 1000), a TTA16 stream
     bit-equal to offline TTA16, plain and TTA16 predict ms; the ACCDOA
     families' identity TTA equal to their plain decode; then a 2-epoch
     `cli train --synthetic` of the mel_iv flagship, `average-ckpts --last
     2` and `predict` of the average, `eval --tta --bg-bias-sweep` (K2
     forward once a step: the loss stays on the plain forward), `calibrate
     --tta`, `predict --calibration` (TTA turned on by the file: the CSV of
     `predict --tta` with its knobs), and `predict --stream --tta --overlap
     0.5` of the seeded mel_iv flagship (the CSV of `--tta --overlap 0.5`).
 16. the serving daemon and the artifact on the full-width flagship, seeded
     weights: the slot check (does a row's output depend on its batch slot,
     or on the rows beside it? each row of a batch of 8 alone among zeros
     in every slot, in its own slot among another stream's windows, the
     batch permuted and run twice, bit for bit, at T = 250 and 1000 on mel
     and mel_iv); K3's host µs a forward through launch_forward and through
     the operator seld_tpu_torch::flash_attention_fwd, in turns; export at
     T = 250 and 1000 on mel and mel_iv (the operator 4 times in each
     program's graph at T = 1000, 0 at T = 250; the artifact's 60 s predict
     bit-equal to the checkpoint's at overlap 0 and 0.5; K1 or K4 once and
     K3 forward 4 a forward through the artifact; both predicts timed; the
     artifact's size on disk; the T = 1000 mel artifact written by `cli
     export` of a run's best checkpoint); SELDServer on 127.0.0.1:0 serving 1 and 4
     concurrent streams of the 60 s clip in 1 s chunks with and without
     --batch-streams at overlap 0 and 0.5, 4 streams in chunks of 1, 0.7,
     1.3 and 1.9 s (batching must run fewer forwards than the device
     lock), and 4 batched streams at T = 1000 (every stream equal to
     offline, K1 / K4 launches equal to the streams' frame blocks, K3
     forward 4 a forward; per-stream wall ms and audio-seconds served per
     second); `cli serve --artifact --port 0 --max-streams 2
     --batch-streams` of the T = 1000 mel artifact in a new process (the
     program loaded there, K3's operator in it), two streams equal to the
     artifact's offline predict; the phase's steps timed; peak memory.
 17. int8 (seld_tpu_torch/quant.py) on the full-width flagship, seeded
     weights: torch._int_mm (cuBLASLt's int8 GEMM) bit-equal to its
     float64 plain version at every distinct (rows, K, N) of the T = 250
     int8 forward, each timed against a bf16 torch.matmul of its shape
     and its bound, and int8_matmul's padding at shapes off the GEMM's
     rules; the seeded 60 s clip predicted bf16, int8 and weight-only at
     T = 250 on mel and T = 1000 on mel_iv (median of five each, peak
     memory, the cells that agree with the bf16 grid, exact K1 / K4 / K3
     forward and int8 GEMM launches; each profiled once: kernel time by
     family); the int8 stream bit-equal to the offline int8 predict; int8
     under TTA (3 views) with exact launches, equal whichever of tta()
     and quantize() came first; the int8 and
     weight-only artifacts (export --int8-calib-wavs), their grids equal to
     the predictor's, their sizes; a one-epoch `cli train --synthetic
     train.qat=true` at T = 250 (K2 and K1 exact), `cli eval --int8` and
     `--int8 --int8-weight-only` of it (K2 forward once a step); timed QAT
     and plain train steps at T = 1000 (K3 forward, dQ, dK/dV 4 each);
     `cli serve --int8-calib-wavs` serving one stream equal to the offline
     int8 predict; the phase's seconds.
 18. knowledge distillation (seld_tpu_torch/distill.py) with phase 6's
     trained flagship as the teacher: `cli train --synthetic
     model.model_type=crnn train.distill_ckpt=<its checkpoints>` for one
     epoch at full width (the "Distillation: teacher resnet_conformer ...
     -> student crnn" line, finite kd and hard in metrics.jsonl, K2
     forward = train + eval steps, backward = train steps, K1 3, K3 0);
     the distilled CRNN train step timed against the plain one (step ms,
     peak memory, each profiled: kernel ms by family), the teacher's eval
     forward alone (timed, profiled) and the grid KD loss alone at
     (16, 250, 14, 648), forward and forward + backward, against its
     bytes bound; one QAT + distill step whose teacher output is the
     teacher's eval forward bit for bit; a seeded T = 1000 flagship
     teacher distilling a default Conformer (K3 forward 4 + the student's
     blocks a step, dQ and dK/dV the student's); a seeded
     multi_accdoa_conformer teacher distilling a multi_accdoa_conformer
     under `distill_track_matching` permutation and position (K2 never;
     the first step's permutation-invariant KD at most the slot-wise one).
It prints the launch counts of phases 9, 10, 14, 15, 16, 17 and 18, one
JSON line of kernel figures (each row's `launches_accdoa`: its launches on
phase 14's paths; `launches_stream` and `launches_tta`: on phase 15's;
`launches_served` and `launches_artifact` on K1, K3 forward and K4: on
phase 16's; K3 forward's `host_us_operator`; `launches_int8` and
`launches_qat` on K1, K2, K3 and K4: on phase 17's; `launches_distill` on
K1, K2 and K3: on phase 18's; `launches_traced` on K2 and K3: counted by
name in phase 7's trace; `launches_import` on K1: phase 4's imported
predicts), the seconds of the whole run, the nvidia-smi line, and last
{"ok": true, "device": {...}}. The CLI logs to standard output; before the
last lines every thread is joined and the log handlers are taken off it.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import itertools
import json
import logging
import math
import re
import shutil
import struct
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
BF16_FLOPS = 989e12  # dense bf16 in the tensor cores
INT8_OPS = 1979e12  # dense int8 in the tensor cores
HBM_BYTES_PER_S = 3.35e12
K1_TOL_DB = 5e-3  # float32 DFT-as-GEMM against float32 GEMMs / rFFT
# K4's IV and GCC planes: the JAX package's bar for its spatial kernel
K4_TOL = 1e-4
K4_ACS_TOL = 1e-5  # audio-side against feature-side transform, as tests/test_acs.py
# K2 against its plain version: float32 exp and sums in another order
K2_FWD_TOL = dict(rtol=1e-5, atol=1e-6)
K2_GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
# K3 in float32 against its plain version: the JAX kernel tests' tolerances
K3_FWD_ATOL, K3_LSE_ATOL = 2e-5, 1e-5
K3_GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
K3_BF16_RATIO = 1.5  # bf16 kernel error over the bf16 plain version's own error
F32_LOGIT_TOL = 1e-3  # card vs CPU float32, sums in other orders
LONG_WINDOW_SECONDS = 20.0  # T = 1000 frames: ragged against every power-of-two tile
CLIP_SECONDS = 60
# kernel-name patterns -> family for the profile of one predict, first match wins
FAMILIES = (
    ("K3 flash attention forward", r"flash_fwd_"),
    ("K3 flash attention dQ", r"flash_dq_"),
    ("K3 flash attention dK/dV", r"flash_dkv_"),
    ("K1 log-mel", r"log_mel_(mixed_|dft_)?kernel"),
    ("K4 spatial features", r"spatial_(mixed_|dft_)?kernel"),
    ("K2 grid loss forward", r"grid_loss_fwd_kernel"),
    ("K2 grid loss backward", r"grid_loss_bwd_kernel"),
    ("optimizer (multi-tensor)", r"multi_tensor"),
    ("dropout masks", r"bernoulli|distribution"),
    ("memcpy / memset", r"memcpy|memset"),
    ("BatchNorm / LayerNorm", r"batch_norm|layer_norm|welford|bn_fw|bn_bw"),
    ("NCHW <-> NHWC transform", r"nchwToNhwc|nhwcToNchw"),
    ("convolution", r"conv|implicit|dgrad|wgrad|fprop|sm90_xmma|cudnn|winograd"),
    ("GEMM", r"gemm|cutlass|cublas|nvjet|sm90_"),
    ("softmax / reduction", r"softmax|reduce|max_|argmax"),
    ("copy / cast / elementwise", r"elementwise|copy|cat|fill|vectorized|unrolled"),
)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, run_ahead: bool = False,
            spin_ms: float = 25.0) -> float:
    """Mean device time of fn() over iters launches, by CUDA events.

    run_ahead: first occupy the device with a spin_ms spin, so that the host
    has queued every launch by the time the device starts on them and the
    events time the device alone. Without it a kernel shorter than the
    host's launch cost (tens of microseconds, and it varies by host) is
    timed at the host's rate. The paths that are host-bound by nature (a
    model forward) are timed without it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if run_ahead:
        torch.cuda._sleep(int(spin_ms * 1e-3 * torch.cuda.get_device_properties(0).clock_rate
                              * 1e3))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 200) -> float:
    """Host wall time of one fn() call in microseconds, over `calls` calls
    with no synchronize between them: what a launch costs the host."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def kernel_ms(fn, host_us_per_call: float = 0.0) -> float:
    """Device time of a kernel-sized fn(): launches queued ahead of the
    device, behind a spin of 25 ms or three times the host time of the 20
    calls, whichever is longer."""
    return cuda_ms(fn, run_ahead=True, spin_ms=max(25.0, 3 * 20 * host_us_per_call * 1e-3))


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
    from seld_tpu_torch.config import Config, config_to_dict

    info = cli_json(["info"])
    devices = info["devices"]
    if (devices["platform"] != "gpu" or devices["device_count"] != torch.cuda.device_count()
            or devices["device_count"] != 1 or name not in devices["devices"][0]
            or info["config"] != json.loads(json.dumps(config_to_dict(Config())))):
        raise AssertionError(f"cli info: {devices}")
    print(f"[device] cli info: platform {devices['platform']}, {devices['device_count']} "
          f"device: {devices['devices'][0]}; its config equals Config()'s")
    return name, smi


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from seld_tpu_torch.ops import _build

    names = sorted(src.stem for src in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc each, side by side
        infos = list(pool.map(_build.build, names))
    for name, info in zip(names, infos):
        if info is None:
            print(f"[build] {name}: built already ({_build.library_path(name).name})")
            continue
        print(f"[build] {name}: {info['seconds']:.2f} s")
        # ptxas names each entry function, then its resources; of K1's, K2's
        # and K3's instantiations only the main path's are shown (n_fft = 960
        # as R = 15 with float2 loads, M = 14, Dh = 64); K3's wgmma kernels
        # (forward, dQ, dK/dV), every instantiation of K4's FFT kernel and the
        # mixed-radix kernels of K1 and K4 must not spill; the DFT-tile and
        # mixed-radix kernels of K1 and K4 are printed
        shown, entry = True, ""
        for line in info["log"].splitlines():
            if "_dft_kernel" in entry and ("registers" in line or "spill" in line):
                # the DFT-tile kernels of K1 and K4, every one
                print(f"[build]   {entry.split('dft')[-1][:30]}: {line.strip()}")
            mixed = re.search(r"log_mel_mixed_kernel|spatial_mixed_kernelILi\d", entry)
            if mixed and ("registers" in line or "spill" in line):
                # the mixed-radix kernels of K1 and K4, every one: none may spill
                print(f"[build]   {mixed.group(0).replace('ILi', ' set ')}: {line.strip()}")
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                shown = (("grid_loss" not in line or "ILi14E" in line)
                         and ("flash_" not in line or "kernelILi64E" in line)
                         and ("log_mel" not in line or "ILi15ELb1E" in line)
                         and "spatial_kernel" not in line)
                if shown and ("grid_loss" in line or "flash_" in line or "log_mel" in line):
                    print(f"[build]   {entry}:")
            elif "spill" in line and ("wgmma" in entry or "mixed_kernel" in entry
                                      or "spatial_kernel" in entry
                                      and "_dft_kernel" not in entry):
                spills = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
                if any(spills):
                    raise AssertionError(f"{entry} spills: {line.strip()}")
            if shown and ("registers" in line or "spill" in line):
                print(f"[build]   {line.strip()}")
        if name == "spatial_kernel":
            k4_build_report(info["log"])
    k3_build_report()


def k4_build_report(log: str) -> None:
    """K4's registers, spills and static shared memory for each n_fft and
    feature set (the float2-load instantiations; the scalar-load ones
    differ only in their loads), from ptxas -v."""
    sets = ("mel", "mel_iv", "mel_gcc")
    found, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"spatial_kernelILi(\d+)ELi(\d)ELb([01])E", line)
            entry = (int(m.group(1)), int(m.group(2)), m.group(3) == "1") if m else None
            if entry:
                found[entry] = {}
        elif entry and "spill" in line:
            found[entry]["spill"] = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif entry and "registers" in line:
            found[entry]["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            found[entry]["smem"] = int(smem.group(1)) if smem else 0
    if len(found) != 24:
        raise AssertionError(f"K4: {len(found)} instantiations in ptxas's log, expected 24")
    for (r, kset, vec2), res in sorted(found.items()):
        if vec2:
            print(f"[build]   K4 n_fft={64 * r:4d} {sets[kset]:7s}: {res['regs']} registers, "
                  f"{res.get('spill', 0)} bytes spilled, {res['smem']} bytes of shared memory")
    print(f"[build] K4: no spills in its {len(found)} instantiations (n_fft x feature set x "
          f"load width); most registers {max(v['regs'] for v in found.values())}")


def k3_build_report() -> None:
    """K3's wgmma kernels (forward, dQ, dK/dV) at Dh = 64: their dynamic
    shared memory, and where cuobjdump exists, the count of HGMMA (wgmma)
    instructions in each one's SASS (dQ's instantiation for K3's own
    launches; the ring modes' has the same products)."""
    import ctypes

    from seld_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(_build.library_path("flash_attention_kernel")))
    lib.seld_flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.seld_flash_attention_smem_bytes.restype = ctypes.c_int
    fwd, bwd = (lib.seld_flash_attention_smem_bytes(64, forward) for forward in (1, 0))
    print(f"[build] K3 wgmma forward at Dh = 64: {fwd} bytes of dynamic shared memory a block "
          f"(256 owned queries, 3 stages of 64-key K/V tiles, 1 KB alignment); dQ and dK/dV: "
          f"{bwd} bytes (3 stages of 64-row Q/dO or K/V tiles, 128 owned rows)")
    beside_nvcc = Path(_build._nvcc()).parent / "cuobjdump"
    cuobjdump = str(beside_nvcc) if beside_nvcc.exists() else shutil.which("cuobjdump")
    if cuobjdump is None:
        print("[build] cuobjdump not found: HGMMA count not shown")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path("flash_attention_kernel"))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = defaultdict(int), ""
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
        elif "HGMMA" in line and "wgmma_kernelILi64E" in fn and "Lb1E" not in fn:
            counts[next(n for key, n in (("flash_fwd_", "forward"), ("flash_dq_", "dQ"),
                                         ("flash_dkv_", "dK/dV")) if key in fn)] += 1
    print(f"[build] HGMMA instructions in the Dh = 64 SASS: forward {counts['forward']}, dQ "
          f"{counts['dQ']}, dK/dV {counts['dK/dV']} (per streamed tile: 4 + 4, 4 + 4 + 4 and "
          f"4 + 4 + 3 x 4)")
    if not all(counts[n] for n in ("forward", "dQ", "dK/dV")):
        raise AssertionError(f"K3's wgmma kernels hold no HGMMA: {dict(counts)}")


def library_log_mel(frames: torch.Tensor, window: torch.Tensor,
                    fb: torch.Tensor) -> torch.Tensor:
    """The same function as K1 from PyTorch's own calls: each frame is one
    hop of a center=False STFT of the concatenated frames."""
    n_fft = frames.shape[1]
    spec = torch.stft(frames.reshape(-1), n_fft=n_fft, hop_length=n_fft,
                      window=window, center=False, return_complex=True)
    power = spec.real.square() + spec.imag.square()  # (bins, N)
    return 10.0 * torch.log10(torch.clamp_min(power.T @ fb, 1e-10))


def library_log_mel_padded(padded: torch.Tensor, hop: int, window: torch.Tensor,
                           fb: torch.Tensor) -> torch.Tensor:
    """K1's in-place function from PyTorch's own calls: a center=False STFT
    of the (C, n) reflect-padded waveform -> (C, T, n_mels)."""
    spec = torch.stft(padded, n_fft=window.shape[0], hop_length=hop, window=window,
                      center=False, return_complex=True)  # (C, bins, T)
    power = spec.real.square() + spec.imag.square()
    return 10.0 * torch.log10(torch.clamp_min(power.transpose(1, 2) @ fb, 1e-10))


def k1_bound(n: int, n_fft: int, fb: torch.Tensor, input_bytes: int | None = None) -> dict:
    """The least card time for K1's function on n frames; fb is the
    (n_fft // 2 + 1, n_mels) filterbank of this run.

    Bytes: the input read once (by default the n frames; for frames read in
    place, `input_bytes` of the padded waveform they view), the filterbank
    read once, the log-mel written once. Operations: the least arithmetic
    that computes the function: the Hann window (n_fft multiplies), a real
    FFT (2.5 n_fft log2 n_fft, the usual count), the power (3 per bin), the
    filterbank product over its nonzero entries (2 each) and the dB (3 per
    mel). `gemm_flops` is the arithmetic of the plain version, the DFT as
    float32 GEMMs at the real bins and mels, and `gemm_ms` its floor."""
    n_freqs, n_mels = fb.shape
    nnz = int((fb != 0).sum())
    if input_bytes is None:
        input_bytes = 4 * n * n_fft
    n_bytes = input_bytes + 4 * (fb.numel() + n * n_mels)
    ops = n * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_freqs + 2 * nnz + 3 * n_mels)
    gemm_flops = 2 * n * n_fft * 2 * n_freqs + 2 * n * n_freqs * n_mels
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "ops": ops,
        "gemm_flops": gemm_flops, "gemm_ms": gemm_flops / F32_FLOPS * 1e3,
    }


def k1_check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float = K1_TOL_DB) -> float:
    err = (got - want).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"K1 {name}: max |kernel - reference| {err} dB over {tol}")
    return err


def phase_k1(dev: torch.device) -> dict:
    import torch.nn.functional as F

    from seld_tpu_torch.config import FeatureConfig, ModelConfig
    from seld_tpu_torch.features.mel import frame_signal, hann_window, mel_filterbank
    from seld_tpu_torch.ops.mel_cuda import (
        KERNEL_N_FFT,
        log_mel_frames,
        log_mel_frames_reference,
    )

    feat = FeatureConfig()
    n_fft, n_mels, hop, sr = feat.n_fft, feat.n_mels, feat.hop_length, feat.sample_rate
    channels = ModelConfig().n_channels
    t_frames = 1 + CLIP_SECONDS * sr // hop
    # the main path's frame count: 4 channels x (1 + 60 s * 50 frames/s)
    n = channels * t_frames
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((n, n_fft), generator=g, device=dev)

    def constants(nf: int):
        return (torch.from_numpy(hann_window(nf)).to(dev),
                torch.from_numpy(mel_filterbank(nf // 2 + 1, n_mels, sr)).to(dev))

    window, fb = constants(n_fft)
    got = log_mel_frames(frames)
    torch.cuda.synchronize()
    err = k1_check(f"N={n}", got, log_mel_frames_reference(frames))
    lib_err = k1_check(f"N={n} vs stft chain", got, library_log_mel(frames, window, fb))
    print(f"[K1] N={n}: max |kernel - plain| {err:.3e} dB, "
          f"max |kernel - stft chain| {lib_err:.3e} dB (tolerance {K1_TOL_DB})")

    ragged = torch.randn((37, n_fft), generator=g, device=dev)
    r_err = k1_check("N=37", log_mel_frames(ragged), log_mel_frames_reference(ragged))
    silence = log_mel_frames(torch.zeros((8, n_fft), device=dev))
    s_err = k1_check("silence", silence, torch.full_like(silence, -100.0), 1e-4)
    torch.cuda.synchronize()
    print(f"[K1] N=37: max |kernel - plain| {r_err:.3e} dB; silence: max |out + 100| {s_err:.3e} dB")

    # the main path's input: frame_signal's (4, 3001, 960) view of the
    # reflect-padded seeded 60 s clip, read in place
    wave = 0.1 * torch.randn((channels, CLIP_SECONDS * sr), generator=g, device=dev)
    padded = F.pad(wave, (n_fft // 2, n_fft // 2), mode="reflect")
    view = frame_signal(wave, n_fft, hop)
    if view.shape != (channels, t_frames, n_fft) or view.is_contiguous():
        raise AssertionError(f"frame_signal gave {tuple(view.shape)}, contiguous "
                             f"{view.is_contiguous()}")
    before = log_mel_frames.launches
    got_v = log_mel_frames(view)
    torch.cuda.synchronize()
    if log_mel_frames.launches != before + 1:
        raise AssertionError("K1 on the in-place view did not launch exactly once")
    v_err = k1_check("in-place view", got_v, log_mel_frames_reference(
        view.reshape(-1, n_fft)).reshape(channels, t_frames, n_mels))
    v_lib_err = k1_check("in-place view vs stft chain", got_v,
                         library_log_mel_padded(padded, hop, window, fb))
    print(f"[K1] in place, view {tuple(view.shape)} strides {view.stride()}: max |kernel - "
          f"plain on its contiguous copy| {v_err:.3e} dB, max |kernel - stft chain| "
          f"{v_lib_err:.3e} dB; 1 launch")

    for nf in KERNEL_N_FFT:
        fr = torch.randn((n, nf), generator=g, device=dev)
        out = log_mel_frames(fr, n_fft=nf)
        e_plain = k1_check(f"n_fft={nf}", out, log_mel_frames_reference(fr))
        e_lib = k1_check(f"n_fft={nf} vs stft chain", out, library_log_mel(fr, *constants(nf)))
        print(f"[K1] n_fft={nf}, N={n}: max |kernel - plain| {e_plain:.3e} dB, "
              f"max |kernel - stft chain| {e_lib:.3e} dB")
    out = log_mel_frames(view, n_mels=40)
    e40 = k1_check("n_mels=40", out, log_mel_frames_reference(
        view.reshape(-1, n_fft), n_mels=40).reshape(channels, t_frames, 40))
    print(f"[K1] n_mels=40 on the in-place view: max |kernel - plain| {e40:.3e} dB")
    del fr, out

    # times in turns inside this call; each kernel_ms is a mean of 20 launches
    runs = {
        "kernel": lambda: log_mel_frames(frames),
        "plain": lambda: log_mel_frames_reference(frames),
        "stft chain": lambda: library_log_mel(frames, window, fb),
        "kernel in place": lambda: log_mel_frames(view),
        "stft chain in place": lambda: library_log_mel_padded(padded, hop, window, fb),
    }
    times = defaultdict(list)
    for turn in range(3):
        for name, fn in (runs.items() if turn % 2 == 0 else reversed(runs.items())):
            times[name].append(kernel_ms(fn))
    ms = {name: float(np.median(v)) for name, v in times.items()}
    for name, v in times.items():
        print(f"[K1] {name:20s} median {ms[name]:.4f} ms of turns "
              f"{', '.join(f'{t:.4f}' for t in v)}")
    b = k1_bound(n, n_fft, fb)
    bv = k1_bound(n, n_fft, fb, input_bytes=padded.numel() * 4)
    k1_ms = ms["kernel"]
    print(f"[K1] bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes'] / 1e6:.2f} MB "
          f"at 3.35 TB/s; {b['ops'] / 1e9:.3f} GFLOP at 67 TFLOP/s f32): kernel at "
          f"{100 * b['bound_ms'] / k1_ms:.2f} % of it, {b['bytes'] / (k1_ms * 1e-3) / 1e12:.2f} "
          f"TB/s; {ms['stft chain'] / k1_ms:.2f}x the stft chain's speed")
    print(f"[K1] in place: bound {bv['bound_ms']:.4f} ms by {bv['bound_by']} "
          f"({bv['bytes'] / 1e6:.2f} MB: {padded.numel() * 4 / 1e6:.2f} MB padded waveform, "
          f"{4 * n * n_mels / 1e6:.2f} MB out, {4 * fb.numel() / 1e6:.2f} MB filterbank): kernel "
          f"at {100 * bv['bound_ms'] / ms['kernel in place']:.2f} % of it; "
          f"{ms['stft chain in place'] / ms['kernel in place']:.2f}x the stft chain's speed")
    print(f"[K1] plain version: DFT-as-GEMM arithmetic at the real {fb.shape[0]} bins, "
          f"{b['gemm_flops'] / 1e9:.2f} GFLOP, f32 floor {b['gemm_ms']:.4f} ms; "
          f"{b['gemm_flops'] / (ms['plain'] * 1e-3) / 1e12:.2f} TFLOP/s")
    return {
        "name": "K1", "route": "cuda",
        "source": "seld_tpu_torch/csrc/mel_kernel.cu",
        "replaces": "seld_tpu/ops/mel_pallas.py:77",
        "launches": None, "max_abs_err": max(err, v_err), "ms": k1_ms, "plain_ms": ms["plain"],
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": ms["stft chain"],
    }


def k2_bounds(n: int, m: int, g: int) -> dict:
    """The least card time for K2's two functions on (n, m, g) float32
    logits and an (n, g) 16-bit mask. Bytes: forward reads the logits and
    the mask and writes sq and p_bg; backward reads the logits, the mask
    and the cotangent of sq, as the main path's MSE loss gives it ("bwd"),
    or both cotangents ("bwd both"), and writes dlogits. Operations, per
    cell: forward max, subtract, exp, sum, divide, target, difference and
    square-add over m (8 m); backward the same softmax plus c and the
    gradient terms (12 m, 14 m). All are far under the bytes."""
    cells = n * g
    out = {}
    for name, n_bytes, ops in (
        ("fwd", cells * (4 * m + 2 + 8), cells * 8 * m),
        ("bwd", cells * (4 * m + 2 + 4 + 4 * m), cells * 12 * m),
        ("bwd both", cells * (4 * m + 2 + 8 + 4 * m), cells * 14 * m),
    ):
        bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        out[name] = {"bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "bytes": n_bytes, "ops": ops}
    return out


def k2_case(dev, n: int, m: int, g: int, seed: int, kind: str = "sparse"):
    """Seeded logits and an int16 bitmask: "sparse" has 90 % background
    cells and random event bits elsewhere, "background" is all zeros,
    "dense" sets several bits in every cell, bit m-2 among them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 3.0 * torch.randn((n, m, g), generator=gen, device=dev)
    bits = torch.randint(1, 2 ** (m - 1), (n, g), generator=gen, device=dev)
    if kind == "sparse":
        keep = torch.rand((n, g), generator=gen, device=dev) >= 0.9
        mask = torch.where(keep, bits, torch.zeros_like(bits))
    elif kind == "background":
        mask = torch.zeros_like(bits)
    else:
        mask = bits | (1 << (m - 2)) | 1
    return x, mask.to(torch.int16)


def phase_k2(dev: torch.device) -> list[dict]:
    from seld_tpu_torch.config import Config, GridConfig, LossConfig
    from seld_tpu_torch.losses import SELDLossFn
    from seld_tpu_torch.ops.loss_cuda import grid_loss_terms, grid_loss_terms_reference

    cfg = Config()
    m, g = cfg.grid.num_classes, cfg.grid.n_cells
    b, t = cfg.train.batch_size, cfg.window.window_frames(cfg.features)
    n_main = b * t  # the main path's rows: one train batch
    worst = {"fwd": 0.0, "bwd": 0.0}
    for n, kind in ((n_main, "sparse"), (37, "sparse"), (n_main, "background"), (37, "dense")):
        x, mask = k2_case(dev, n, m, g, seed=n + len(kind), kind=kind)
        gen = torch.Generator(device=dev).manual_seed(1)
        w_sq = torch.randn((n, g), generator=gen, device=dev)
        w_bg = torch.randn((n, g), generator=gen, device=dev)
        launches = (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches)
        xk = x.clone().requires_grad_(True)
        sq, pbg = grid_loss_terms(xk, mask, m)
        # an expanded (stride-0) cotangent on sq, as a sum's backward gives
        (dk_both,) = torch.autograd.grad((sq, pbg), xk, (w_sq, w_bg), retain_graph=True)
        (dk_sq,) = torch.autograd.grad(sq.sum(), xk)  # g_bg is None here
        torch.cuda.synchronize()
        if (grid_loss_terms.fwd_launches - launches[0],
                grid_loss_terms.bwd_launches - launches[1]) != (1, 2):
            raise AssertionError("K2's launch counters did not move by (1, 2)")
        xr = x.clone().requires_grad_(True)
        sq_r, pbg_r = grid_loss_terms_reference(xr, mask, m)
        (dr_both,) = torch.autograd.grad((sq_r, pbg_r), xr, (w_sq, w_bg), retain_graph=True)
        (dr_sq,) = torch.autograd.grad(sq_r.sum(), xr)
        torch.testing.assert_close(sq, sq_r, **K2_FWD_TOL)
        torch.testing.assert_close(pbg, pbg_r, **K2_FWD_TOL)
        torch.testing.assert_close(dk_both, dr_both, **K2_GRAD_TOL)
        torch.testing.assert_close(dk_sq, dr_sq, **K2_GRAD_TOL)
        errs = {"fwd": max((sq - sq_r).abs().max().item(), (pbg - pbg_r).abs().max().item()),
                "bwd": max((dk_both - dr_both).abs().max().item(),
                           (dk_sq - dr_sq).abs().max().item())}
        print(f"[K2] N={n} {kind}: max |kernel - plain| forward {errs['fwd']:.3e}, "
              f"gradient {errs['bwd']:.3e} (rtol 1e-5 / 2e-4)")
        if n == n_main:
            worst = {k: max(worst[k], errs[k]) for k in worst}
        del xk, xr, sq, pbg, sq_r, pbg_r, dk_both, dk_sq, dr_both, dr_sq

    # times at the main path's shape; 145 MB of logits, so the 50 MB L2 is cold
    x, mask = k2_case(dev, n_main, m, g, seed=0)
    mask_btg = mask.reshape(b, t, g)
    gen = torch.Generator(device=dev).manual_seed(2)
    w_sq = torch.randn((n_main, g), generator=gen, device=dev)
    w_bg = torch.randn((n_main, g), generator=gen, device=dev)
    em = torch.ones(b, device=dev)
    loss_fn = SELDLossFn(LossConfig(), GridConfig())
    times = {}
    for name, terms in (("kernel", grid_loss_terms), ("plain", grid_loss_terms_reference)):
        with torch.no_grad():
            times[name, "fwd"] = kernel_ms(lambda: terms(x, mask, m))
        xg = x.clone().requires_grad_(True)
        outs = terms(xg, mask, m)
        # the main path's backward: MSE without CL puts a cotangent on sq alone
        times[name, "bwd"] = kernel_ms(
            lambda: torch.autograd.grad(outs[0], xg, w_sq, retain_graph=True))
        times[name, "bwd both"] = kernel_ms(
            lambda: torch.autograd.grad(outs, xg, (w_sq, w_bg), retain_graph=True))
        times[name, "fwd+bwd"] = kernel_ms(
            lambda: torch.autograd.grad(terms(xg, mask, m)[0], xg, w_sq))
        del outs, xg
    # the library call: the unfused eager chain of from_bitmask(fused=False),
    # logits to the scalar loss and back
    x4 = x.reshape(b, t, m, g)
    with torch.no_grad():
        times["library", "fwd"] = kernel_ms(
            lambda: loss_fn.from_bitmask(x4, mask_btg, em, fused=False))
        times["fused loss", "fwd"] = kernel_ms(
            lambda: loss_fn.from_bitmask(x4, mask_btg, em, fused=True))
    xg = x4.clone().requires_grad_(True)
    for name, fused in (("library", False), ("fused loss", True)):
        total = loss_fn.from_bitmask(xg, mask_btg, em, fused=fused).total
        times[name, "bwd"] = kernel_ms(
            lambda: torch.autograd.grad(total, xg, retain_graph=True))
        times[name, "fwd+bwd"] = kernel_ms(lambda: torch.autograd.grad(
            loss_fn.from_bitmask(xg, mask_btg, em, fused=fused).total, xg))
        del total
    bounds = k2_bounds(n_main, m, g)
    rows = []
    for part, line in (("fwd", "150"), ("bwd", "205")):
        bd = bounds[part]
        k_ms = times["kernel", part]
        print(f"[K2] {part} N={n_main}: kernel {k_ms:.4f} ms, plain {times['plain', part]:.4f} ms, "
              f"fused=False eager chain {times['library', part]:.4f} ms (whole loss through "
              f"K2 {times['fused loss', part]:.4f} ms); bound {bd['bound_ms']:.4f} ms by "
              f"{bd['bound_by']} ({bd['bytes'] / 1e6:.1f} MB at 3.35 TB/s): kernel at "
              f"{100 * bd['bound_ms'] / k_ms:.1f} % of it, "
              f"{bd['bytes'] / (k_ms * 1e-3) / 1e12:.3f} TB/s")
        rows.append({
            "name": f"K2 {part}", "route": "cuda",
            "source": "seld_tpu_torch/csrc/grid_loss_kernel.cu",
            "replaces": f"seld_tpu/ops/loss_pallas.py:{line}",
            "launches": None, "max_abs_err": worst[part], "ms": k_ms,
            "plain_ms": times["plain", part], "bound_ms": bd["bound_ms"],
            "bound_by": bd["bound_by"], "library_ms": times["library", part],
        })
    bd = bounds["bwd both"]
    print(f"[K2] bwd with both cotangents (the CL term on): kernel "
          f"{times['kernel', 'bwd both']:.4f} ms, plain {times['plain', 'bwd both']:.4f} ms; bound "
          f"{bd['bound_ms']:.4f} ms ({bd['bytes'] / 1e6:.1f} MB): kernel at "
          f"{100 * bd['bound_ms'] / times['kernel', 'bwd both']:.1f} % of it")
    print(f"[K2] forward+backward N={n_main}: kernels {times['kernel', 'fwd+bwd']:.4f} ms, plain "
          f"{times['plain', 'fwd+bwd']:.4f} ms; whole MSE loss and its gradient: through K2 "
          f"{times['fused loss', 'fwd+bwd']:.4f} ms, fused=False eager chain "
          f"{times['library', 'fwd+bwd']:.4f} ms")
    return rows


def k3_bounds(bh: int, t: int, dh: int, dtype: torch.dtype) -> dict:
    """The least card time for K3's three functions on (bh, t, dh) inputs.

    Operations: the products each function needs at 2 bh t^2 dh flops apiece:
    forward two (q k^T, p v); dQ three (q k^T, dO v^T, ds k); dK/dV four
    (q k^T, dO v^T, p^T dO, ds^T q); "bwd" is the least for dq, dk and dv
    together, five (the two passes recompute q k^T and dO v^T, and the bf16
    dK/dV kernel adds one for p's remainder, so they do eight). At the dense
    bf16 tensor-core peak for bf16 inputs, at the float32 FMA peak for
    float32 ones. Bytes: q, k, v (and dO, lse, delta)
    read once, the outputs written once."""
    elem = torch.empty((), dtype=dtype).element_size()
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    mat, row = bh * t * dh * elem, bh * t * 4
    out = {}
    for name, products, n_bytes in (
        ("fwd", 2, 4 * mat + row), ("dq", 3, 5 * mat + 2 * row),
        ("dkv", 4, 6 * mat + 2 * row), ("bwd", 5, 7 * mat + 2 * row),
    ):
        ops = products * 2 * bh * t * t * dh
        bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        out[name] = {"bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "bytes": n_bytes, "ops": ops}
    return out


def k3_case(dev, b: int, h: int, t: int, dh: int, dtype, seed: int, key_scale: float = 1.0):
    """Seeded q, k, v as the model makes them ((B, T, H*Dh) projections
    viewed as (B, H, T, Dh): head and time strides swapped) and a cotangent
    strided the same way."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, w = (torch.randn((b, t, h * dh), generator=gen, device=dev).to(dtype)
                  .view(b, t, h, dh).transpose(1, 2) for _ in range(4))
    return q, k * key_scale, v, w


def check_bf16(what: str, got, plain, exact, lse_atol: float = 1e-4) -> str:
    """Hold a bf16 run's (out, lse, dq, dk, dv) and the bf16 plain
    version's, each against the float32 plain version on the same
    bf16-rounded inputs: the run's largest error at most K3_BF16_RATIO
    times the plain version's (lse, float32 in both, within lse_atol).
    Returns the errors as printed; raises where one is outside."""
    parts = []
    for n, a, p, e in zip(("out", "lse", "dq", "dk", "dv"), got, plain, exact):
        err = (a.float() - e.float()).abs().max().item()
        plain_err = (p.float() - e.float()).abs().max().item()
        parts.append(f"{n} {err:.2e} / {plain_err:.2e}")
        ok = err <= lse_atol if n == "lse" else err <= K3_BF16_RATIO * plain_err + 1e-6
        if not ok:
            raise AssertionError(f"{what}: {n} off by {err} from float32, the bf16 plain "
                                 f"version by {plain_err}")
    return ", ".join(parts)


def k3_run(fn, q, k, v, w):
    """(out, lse, dq, dk, dv) of fn on fresh leaves."""
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out, lse = fn(q, k, v)
    return (out.detach(), lse.detach(), *torch.autograd.grad(out, (q, k, v), w))


def phase_k3(dev: torch.device) -> list[dict]:
    import torch.nn.functional as F

    from seld_tpu_torch.config import Config, WindowConfig
    from seld_tpu_torch.ops import flash_attention as k3

    cfg = Config(window=WindowConfig(window_seconds=LONG_WINDOW_SECONDS))
    b, h = cfg.train.batch_size, cfg.model.resnet_conf_n_heads
    t, dh = cfg.window.window_frames(cfg.features), cfg.model.resnet_conf_d_model // h
    names = ("out", "lse", "dq", "dk", "dv")

    def kernel(q, k, v):
        return k3.flash_attention(q, k, v, return_lse=True)

    def launches():
        fa = k3.flash_attention
        return (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)

    main_err = {}
    # 32 heads in the small cases too: a largest error over a few thousand
    # values is mostly chance, and the bf16 check compares two of them
    cases = [(b, h, t, dh, 1.0), (4, 8, 130, dh, 1.0), (4, 8, 513, dh, 1.0), (4, 8, 64, dh, 1.0),
             (4, 8, 130, 32, 1.0), (4, 8, 200, 128, 1.0), (4, 8, 130, dh, 10.0)]
    for cb, ch, ct, cdh, key_scale in cases:
        shape = f"B*H={cb * ch} T={ct} Dh={cdh}" + (" keys x10" if key_scale != 1.0 else "")
        # float32: the kernel against its plain version
        case = k3_case(dev, cb, ch, ct, cdh, torch.float32, seed=ct + cdh, key_scale=key_scale)
        before = launches()
        copies = k3.flash_attention.copies
        got = k3_run(kernel, *case)
        torch.cuda.synchronize()
        if launches() != tuple(n + 1 for n in before) or k3.flash_attention.copies != copies:
            raise AssertionError(f"K3 {shape}: launch counters moved {before} -> {launches()}, "
                                 f"copies {copies} -> {k3.flash_attention.copies}")
        want = k3_run(k3.flash_attention_reference, *case)
        errs = {n: (a - r).abs().max().item() for n, a, r in zip(names, got, want)}
        print(f"[K3] float32 {shape}: max |kernel - plain| "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + " (atol 2e-5 / lse 1e-5 / gradients rtol 2e-4)")
        # keys x10 sharpen the softmax: no weight on padded keys, 5e-5 as in the JAX tests
        torch.testing.assert_close(got[0], want[0], rtol=0,
                                   atol=5e-5 if key_scale != 1.0 else K3_FWD_ATOL)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=K3_LSE_ATOL * key_scale)
        for a, r in zip(got[2:], want[2:]):
            torch.testing.assert_close(a, r, rtol=K3_GRAD_TOL["rtol"],
                                       atol=K3_GRAD_TOL["atol"] * key_scale)
        del got, want
        # bf16: the kernel and the bf16 plain version, each against the float32
        # plain version on the same bf16-rounded inputs
        case = k3_case(dev, cb, ch, ct, cdh, torch.bfloat16, seed=ct + cdh, key_scale=key_scale)
        got = k3_run(kernel, *case)
        plain = k3_run(k3.flash_attention_reference, *case)
        exact = k3_run(k3.flash_attention_reference, *(x.float() for x in case))
        parts = check_bf16(f"K3 bf16 {shape}", got, plain, exact, lse_atol=1e-4 * key_scale)
        if (cb, ct, key_scale) == (b, t, 1.0):
            main_err = {n: (a.float() - p.float()).abs().max().item()
                        for n, a, p in zip(names, got, plain)}
        print(f"[K3] bf16 {shape}: max error against float32, kernel / bf16 plain: "
              + parts + f" (kernel at most {K3_BF16_RATIO} x plain)")
        del got, plain, exact

    # two backward runs on the same inputs: the same bits
    for dtype in (torch.bfloat16, torch.float32):
        case = k3_case(dev, b, h, t, dh, dtype, seed=5)
        first, second = k3_run(kernel, *case), k3_run(kernel, *case)
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"K3 {dtype}: two runs on the same inputs differ")
    print("[K3] two forward+backward runs bit-equal in bf16 and float32 (no atomics)")
    del first, second

    # the delta the bf16 dQ kernel forms, against row_delta: the same float32
    # products summed in another order
    q, k, v, w = k3_case(dev, b, h, t, dh, torch.bfloat16, seed=7)
    with torch.no_grad():
        out, lse = k3.launch_forward(q, k, v, dh ** -0.5)
        _, delta = k3.launch_dq(q, k, v, w, out, lse, dh ** -0.5)
        want = k3.row_delta(w, out).view(delta.shape)
        size = (w.float() * out.float()).abs().sum(-1).view(delta.shape)
        delta_err = ((delta - want).abs() / size.clamp_min(1e-30)).max().item()
    if not delta_err <= 1e-5:
        raise AssertionError(f"K3 dQ kernel's delta off row_delta's by {delta_err} of "
                             "rowsum|dO out|")
    print(f"[K3] bf16 delta formed in the dQ kernel against row_delta: {delta_err:.2e} of "
          f"rowsum(|dO * out|) at most (bound 1e-5)")
    del q, k, v, w, out, lse, delta, want, size

    # times at the main path's shape
    rows = []
    # products the kernels do: the two passes both recompute q k^T and dO v^T,
    # and in bf16 dv takes one more for p's remainder
    own_products = {torch.bfloat16: {"dq": 3, "dkv": 5, "bwd": 8},
                    torch.float32: {"dq": 3, "dkv": 4, "bwd": 7}}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, w = k3_case(dev, b, h, t, dh, dtype, seed=6)
        scale = dh ** -0.5
        tm = {}
        with torch.no_grad():
            out, lse = k3.launch_forward(q, k, v, scale)
            _, delta = k3.launch_dq(q, k, v, w, out, lse, scale)
            tm["kernel", "fwd"] = kernel_ms(lambda: k3.launch_forward(q, k, v, scale))
            tm["kernel", "dq"] = kernel_ms(lambda: k3.launch_dq(q, k, v, w, out, lse, scale))
            tm["kernel", "dkv"] = kernel_ms(lambda: k3.launch_dkv(q, k, v, w, lse, delta, scale))
            k3_host = {"fwd": host_us(lambda: k3.launch_forward(q, k, v, scale)),
                       "dq": host_us(lambda: k3.launch_dq(q, k, v, w, out, lse, scale)),
                       "dkv": host_us(lambda: k3.launch_dkv(q, k, v, w, lse, delta, scale))}
            tm["plain", "fwd"] = kernel_ms(lambda: k3.flash_attention_reference(q, k, v))
            tm["library", "fwd"] = kernel_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        for name, fn in (("kernel", lambda *a: kernel(*a)[0]),
                         ("plain", lambda *a: k3.flash_attention_reference(*a)[0]),
                         ("library", F.scaled_dot_product_attention)):
            o = fn(*leaves)
            tm[name, "bwd"] = kernel_ms(
                lambda: torch.autograd.grad(o, leaves, w, retain_graph=True))
            if name == "plain":
                tm[name, "dq"] = kernel_ms(
                    lambda: torch.autograd.grad(o, leaves[0], w, retain_graph=True))
                tm[name, "dkv"] = kernel_ms(
                    lambda: torch.autograd.grad(o, leaves[1:], w, retain_graph=True))
            del o
        tm["kernel", "pair"] = tm["kernel", "dq"] + tm["kernel", "dkv"]
        bounds = k3_bounds(b * h, t, dh, dtype)
        bf16 = dtype == torch.bfloat16
        peak = "989 TFLOP/s bf16" if bf16 else "67 TFLOP/s f32 FMA"
        peak_rate = BF16_FLOPS if bf16 else F32_FLOPS
        kind = "bf16" if bf16 else "float32"
        bd = bounds["fwd"]
        print(f"[K3] {kind} forward B*H={b * h} T={t} Dh={dh}: kernel {tm['kernel', 'fwd']:.4f} "
              f"ms, plain {tm['plain', 'fwd']:.4f} ms, scaled_dot_product_attention forward "
              f"{tm['library', 'fwd']:.4f} ms; bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({bd['ops'] / 1e9:.1f} GFLOP at {peak}; {bd['bytes'] / 1e6:.1f} MB): kernel at "
              f"{100 * bd['bound_ms'] / tm['kernel', 'fwd']:.2f} % of it, "
              f"{bd['ops'] / (tm['kernel', 'fwd'] * 1e-3) / 1e12:.1f} TFLOP/s")
        if bf16:
            # the softmax's second bound: B*H*T^2 exponentials at 16 a clock
            # per SM, at the card's own SM count and top clock
            props = torch.cuda.get_device_properties(0)
            exp_rate = 16 * props.multi_processor_count * props.clock_rate * 1e3  # per second
            exp_ms = b * h * t * t / exp_rate * 1e3
            print(f"[K3] bf16 forward's exponentials: {b * h * t * t / 1e6:.1f} M at 16 a clock "
                  f"per SM ({props.multi_processor_count} SMs at {props.clock_rate / 1e6:.3f} "
                  f"GHz): {exp_ms:.4f} ms, beside the tensor cores' {bd['bound_ms']:.4f} ms")
        print(f"[K3] {kind} host time a launch (no synchronize between calls): launch_forward "
              f"{k3_host['fwd']:.1f} us, launch_dq {k3_host['dq']:.1f} us, launch_dkv "
              f"{k3_host['dkv']:.1f} us")
        for part, label, bound in (("dq", "dQ", "dq"), ("dkv", "dK/dV", "dkv"),
                                   ("pair", "dQ + dK/dV", "bwd")):
            bd, k_ms = bounds[bound], tm["kernel", part]
            own = own_products[dtype][bound] * 2 * b * h * t * t * dh
            plain = (f"plain {tm['plain', part]:.4f} ms, " if part != "pair" else
                     f"plain backward {tm['plain', 'bwd']:.4f} ms, ")
            print(f"[K3] {kind} {label} B*H={b * h} T={t} Dh={dh}: kernel {k_ms:.4f} ms, {plain}"
                  f"scaled_dot_product_attention backward (dq, dk and dv in one call) "
                  f"{tm['library', 'bwd']:.4f} ms; the function's bound {bd['bound_ms']:.4f} ms "
                  f"by {bd['bound_by']} ({bd['ops'] / 1e9:.1f} GFLOP at {peak}): kernel at "
                  f"{100 * bd['bound_ms'] / k_ms:.2f} % of it, "
                  f"{bd['ops'] / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s on the function's products, "
                  f"{own / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s on the kernel's own "
                  f"({own / 1e9:.1f} GFLOP: {100 * own / peak_rate / (k_ms * 1e-3):.2f} "
                  f"% of peak)")
        print(f"[K3] {kind} backward as autograd runs it (dQ + dK/dV"
              f"{'' if bf16 else ' + row_delta inside dQ'}): {tm['kernel', 'bwd']:.4f} ms, plain "
              f"{tm['plain', 'bwd']:.4f} ms, scaled_dot_product_attention "
              f"{tm['library', 'bwd']:.4f} ms: kernels / SDPA "
              f"{tm['kernel', 'pair'] / tm['library', 'bwd']:.3f}")
        if bf16:
            for part, line, err in (("fwd", 59, main_err["out"]), ("dq", 105, main_err["dq"]),
                                    ("dkv", 146, max(main_err["dk"], main_err["dv"]))):
                rows.append({
                    "name": f"K3 {part}", "route": "cuda",
                    "source": "seld_tpu_torch/csrc/flash_attention_kernel.cu",
                    "replaces": f"seld_tpu/ops/flash_attention.py:{line}",
                    "launches": None, "max_abs_err": err, "ms": tm["kernel", part],
                    "plain_ms": tm["plain", part], "bound_ms": bounds[part]["bound_ms"],
                    "bound_by": bounds[part]["bound_by"],
                    "library_ms": tm["library", "fwd" if part == "fwd" else "bwd"],
                    "host_us": k3_host[part],
                })
        del leaves, out, lse, delta
    return rows


def k4_bound(t: int, n_fft: int, fb: torch.Tensor, feature_set: str,
             input_bytes: int | None = None) -> dict:
    """The least card time for K4's function on t frames of 4 channels; fb
    is the (n_fft // 2 + 1, n_mels) filterbank of this run.

    Bytes: the input read once (by default the 4 x t frames; for frames
    read in place, `input_bytes` of the padded waveform they view) and the
    features written once. Operations: the least arithmetic that computes
    the function, with FFTs: per channel the Hann window (n_fft), a real FFT
    (2.5 n_fft log2 n_fft), the power (3 per bin), the filterbank product
    over its nonzero entries (2 each) and the dB (3 per mel); "mel_iv" adds
    the energy and three intensities (19 per bin) and three
    normalised-filterbank products; "mel_gcc" adds per pair the
    cross-spectrum and its PHAT scaling (13 per bin) and an inverse real
    FFT. `gemm_ms` is the float32 floor of the plain version's DFT-as-GEMM
    arithmetic at the real bins (the earlier GEMM kernel's form), without padding."""
    from seld_tpu_torch.features.spatial import feature_channels

    n_freqs, n_mels = fb.shape
    nnz = int((fb != 0).sum())
    fft = 2.5 * n_fft * math.log2(n_fft)
    c_out = feature_channels(feature_set)
    if input_bytes is None:
        input_bytes = 4 * 4 * t * n_fft
    n_bytes = input_bytes + 4 * t * c_out * n_mels
    ops = 4 * (n_fft + fft + 3 * n_freqs + 2 * nnz + 3 * n_mels)
    planes = 4
    if feature_set == "mel_iv":
        ops += 19 * n_freqs + 3 * 2 * nnz
        planes = 7
    elif feature_set == "mel_gcc":
        ops += 6 * (13 * n_freqs + fft)
        planes = 16
    ops *= t
    gemm_flops = 2 * 4 * t * n_fft * 2 * n_freqs + 2 * t * n_freqs * n_mels * planes
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": n_bytes, "ops": ops,
        "gemm_flops": gemm_flops, "gemm_ms": gemm_flops / F32_FLOPS * 1e3,
    }


def k4_errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """Largest |got - want| over the mel planes (dB) and over the rest."""
    mel = (got[:, :4] - want[:, :4]).abs().max().item()
    rest = (got[:, 4:] - want[:, 4:]).abs().max().item() if got.shape[1] > 4 else 0.0
    return mel, rest


def k4_check(what: str, errs: tuple[float, float]) -> None:
    if not (errs[0] <= K1_TOL_DB and errs[1] <= K4_TOL):
        raise AssertionError(f"K4 {what} disagrees: {errs[0]} dB / {errs[1]}")


def phase_k4(dev: torch.device) -> list[dict]:
    import torch.nn.functional as F

    from seld_tpu_torch.config import FeatureConfig
    from seld_tpu_torch.features import spatial as oracle
    from seld_tpu_torch.features.acs import N_TRANSFORMS, acs_tables, audio_channel_transform
    from seld_tpu_torch.features.mel import frame_signal, mel_filterbank
    from seld_tpu_torch.ops.mel_cuda import KERNEL_N_FFT, log_mel_frames
    from seld_tpu_torch.ops.spatial_cuda import spatial_features, spatial_features_reference

    feat = FeatureConfig()
    n_fft, n_mels, sr, hop = feat.n_fft, feat.n_mels, feat.sample_rate, feat.hop_length
    sets = ("mel", "mel_iv", "mel_gcc")
    t_main = 1 + CLIP_SECONDS * sr // hop  # a 60 s clip: 3,001 frames
    g = torch.Generator(device=dev).manual_seed(4)
    frames = torch.randn((4, t_main, n_fft), generator=g, device=dev)
    ragged = torch.randn((4, 37, n_fft), generator=g, device=dev)
    silence = torch.zeros((4, 20, n_fft), device=dev)
    # the main path's input: frame_signal's (4, 3001, 960) view of the
    # reflect-padded seeded 60 s clip, read in place
    wave = 0.1 * torch.randn((4, CLIP_SECONDS * sr), generator=g, device=dev)
    padded = F.pad(wave, (n_fft // 2, n_fft // 2), mode="reflect")
    view = frame_signal(wave, n_fft, hop)
    copy = view.contiguous()
    if view.shape != (4, t_main, n_fft) or view.is_contiguous():
        raise AssertionError(f"frame_signal gave {tuple(view.shape)}, contiguous "
                             f"{view.is_contiguous()}")

    def library(x, feature_set):
        return oracle.extract_feature_frames(x, feature_set, n_fft, n_mels, sr)

    main_err = {}
    for feature_set in sets:
        before = spatial_features.launches
        got = spatial_features(frames, feature_set)
        torch.cuda.synchronize()
        if spatial_features.launches != before + 1:
            raise AssertionError("K4's launch counter did not move by one")
        errs = k4_errors(got, spatial_features_reference(frames, feature_set))
        lib_errs = k4_errors(got, library(frames, feature_set))
        r_errs = k4_errors(spatial_features(ragged, feature_set),
                           spatial_features_reference(ragged, feature_set))
        quiet = spatial_features(silence, feature_set)
        s_err = (quiet[:, :4] + 100.0).abs().max().item()
        s_rest = quiet[:, 4:].abs().max().item() if quiet.shape[1] > 4 else 0.0
        again = spatial_features(frames, feature_set)
        before = spatial_features.launches
        got_v = spatial_features(view, feature_set)
        torch.cuda.synchronize()
        if spatial_features.launches != before + 1:
            raise AssertionError("K4 on the in-place view did not launch exactly once")
        v_errs = k4_errors(got_v, spatial_features_reference(copy, feature_set))
        v_lib_errs = k4_errors(got_v, library(view, feature_set))
        print(f"[K4] {feature_set} T={t_main}: max |kernel - plain| {errs[0]:.3e} dB, other "
              f"planes {errs[1]:.3e}; against the rFFT chain {lib_errs[0]:.3e} dB / "
              f"{lib_errs[1]:.3e}; T=37 {r_errs[0]:.3e} dB / {r_errs[1]:.3e}; silence max "
              f"|mel + 100| {s_err:.3e} dB, max |other| {s_rest:.3e} (tolerance "
              f"{K1_TOL_DB} dB / {K4_TOL})")
        print(f"[K4] {feature_set} in place, view {tuple(view.shape)} strides {view.stride()}: "
              f"max |kernel - plain on its contiguous copy| {v_errs[0]:.3e} dB / "
              f"{v_errs[1]:.3e}, against the rFFT chain {v_lib_errs[0]:.3e} dB / "
              f"{v_lib_errs[1]:.3e}; 1 launch")
        for what, e in (("", errs), ("vs rFFT chain", lib_errs), ("T=37", r_errs),
                        ("in place", v_errs), ("in place vs rFFT chain", v_lib_errs)):
            k4_check(f"{feature_set} {what}", e)
        if not (s_err <= 1e-4 and s_rest == 0.0 and bool(torch.isfinite(quiet).all())):
            raise AssertionError(f"K4 {feature_set} on silence: {s_err} / {s_rest}")
        if not torch.equal(got, again):
            raise AssertionError(f"K4 {feature_set}: two runs on the same frames differ")
        main_err[feature_set] = max(*errs, *v_errs)
    print("[K4] two runs bit-equal for every feature set")

    # K4's mel planes run K1's FFT stage and band loop: K1's numbers
    k1 = log_mel_frames(view).transpose(0, 1)
    k1_diff = max((spatial_features(view, fs)[:, :4] - k1).abs().max().item() for fs in sets)
    print(f"[K4] mel planes against K1 on the same in-place frames, every feature set: max "
          f"|K4 - K1| {k1_diff:.3e} dB ({'bit-equal' if k1_diff == 0.0 else 'not bit-equal'})")
    if not k1_diff <= K1_TOL_DB:
        raise AssertionError(f"K4's mel planes differ from K1 by {k1_diff} dB")

    for nf in KERNEL_N_FFT:
        v = frame_signal(wave, nf, nf // 2)
        c = v.contiguous()
        line = []
        for fs in sets:
            e = k4_errors(spatial_features(v, fs), spatial_features_reference(c, fs))
            k4_check(f"{fs} n_fft={nf}", e)
            line.append(f"{fs} {e[0]:.3e} dB / {e[1]:.3e}")
        print(f"[K4] n_fft={nf} in place, T={v.shape[1]}: max |kernel - plain| " + "; ".join(line))
    line = []
    for fs in sets:
        out = spatial_features(view, fs, n_mels=40)
        e = k4_errors(out, spatial_features_reference(copy, fs, n_mels=40))
        k4_check(f"{fs} n_mels=40", e)
        line.append(f"{fs} {e[0]:.3e} dB / {e[1]:.3e}")
    print("[K4] n_mels=40 in place: max |kernel - plain| " + "; ".join(line))
    del v, c, out

    # GCC-PHAT: a channel delayed by 7 samples peaks at lag +7 (column 32 + 7)
    rng = np.random.default_rng(5)
    base = rng.standard_normal(sr // 2 + 64).astype(np.float32)
    delay = 7
    lagged = np.stack([base[64:64 + sr // 2], base[64 - delay:64 - delay + sr // 2],
                       rng.standard_normal(sr // 2).astype(np.float32),
                       rng.standard_normal(sr // 2).astype(np.float32)])
    framed = frame_signal(torch.from_numpy(lagged).to(dev), n_fft, hop)
    peak = int(spatial_features(framed, "mel_gcc")[:, 4].mean(dim=0).argmax())
    print(f"[K4] GCC-PHAT of a {delay}-sample delay: peak at column {peak} (lag {peak - 32})")
    if peak != 32 + delay:
        raise AssertionError(f"K4 GCC lag peak at column {peak}, expected {32 + delay}")

    # ACS: transforming the audio and then K4 equals K4 and then the
    # feature-side signed permutation, for all 16 transforms
    _, ch_perm, ch_sign = acs_tables(18, 36, "mel_iv")
    base_feats = spatial_features(frames, "mel_iv")
    worst = 0.0
    for t in range(N_TRANSFORMS):
        perm, sign = audio_channel_transform(t)
        audio_t = (torch.from_numpy(sign).to(dev)[:, None, None]
                   * frames[torch.from_numpy(perm).to(dev)]).contiguous()
        want = spatial_features(audio_t, "mel_iv")
        got = (torch.from_numpy(ch_sign[t]).to(dev)[None, :, None]
               * base_feats[:, torch.from_numpy(ch_perm[t]).long().to(dev)])
        worst = max(worst, (got - want).abs().max().item())
    print(f"[K4] ACS commutation, 16 transforms at T={t_main}: max |feature-side - audio-side| "
          f"{worst:.3e} (tolerance {K4_ACS_TOL})")
    if not worst <= K4_ACS_TOL:
        raise AssertionError(f"K4 breaks the ACS commutation by {worst}")

    # times in turns inside this call; each kernel_ms is a mean of 20 launches
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sr)).to(dev)
    rows = []
    for feature_set in sets:
        runs = {
            "kernel": lambda: spatial_features(frames, feature_set),
            "plain": lambda: spatial_features_reference(frames, feature_set),
            "rFFT chain": lambda: library(frames, feature_set),
            "kernel in place": lambda: spatial_features(view, feature_set),
            "rFFT chain in place": lambda: library(view, feature_set),
        }
        times = defaultdict(list)
        for turn in range(3):
            for name, fn in (runs.items() if turn % 2 == 0 else reversed(runs.items())):
                times[name].append(kernel_ms(fn))
        ms = {name: float(np.median(v)) for name, v in times.items()}
        for name, v in times.items():
            print(f"[K4] {feature_set:7s} {name:20s} median {ms[name]:.4f} ms of turns "
                  f"{', '.join(f'{x:.4f}' for x in v)}")
        k_ms, kv_ms = ms["kernel"], ms["kernel in place"]
        b = k4_bound(t_main, n_fft, fb, feature_set)
        bv = k4_bound(t_main, n_fft, fb, feature_set, input_bytes=padded.numel() * 4)
        print(f"[K4] {feature_set} T={t_main}: bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
              f"({b['bytes'] / 1e6:.2f} MB at 3.35 TB/s; {b['ops'] / 1e9:.3f} GFLOP with FFTs "
              f"at 67 TFLOP/s f32): kernel at {100 * b['bound_ms'] / k_ms:.2f} % of it; "
              f"{ms['rFFT chain'] / k_ms:.2f}x the rFFT chain's speed; the plain version's "
              f"DFT-as-GEMM arithmetic {b['gemm_flops'] / 1e9:.2f} GFLOP, f32 floor "
              f"{b['gemm_ms']:.4f} ms")
        print(f"[K4] {feature_set} in place: bound {bv['bound_ms']:.4f} ms by {bv['bound_by']} "
              f"({bv['bytes'] / 1e6:.2f} MB: {padded.numel() * 4 / 1e6:.2f} MB padded waveform, "
              f"{(bv['bytes'] - padded.numel() * 4) / 1e6:.2f} MB out): kernel at "
              f"{100 * bv['bound_ms'] / kv_ms:.2f} % of it; "
              f"{ms['rFFT chain in place'] / kv_ms:.2f}x the rFFT chain's speed")
        if feature_set != "mel":  # "mel" takes K1 on the main path
            rows.append({
                "name": f"K4 {feature_set}", "route": "cuda",
                "source": "seld_tpu_torch/csrc/spatial_kernel.cu",
                "replaces": "seld_tpu/ops/spatial_pallas.py:132",
                "launches": None, "max_abs_err": main_err[feature_set], "ms": k_ms,
                "plain_ms": ms["plain"], "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": ms["rFFT chain"],
            })
    return rows


def phase_flagship(dev: torch.device) -> tuple[int, dict]:
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
        state_dict = {k: v.detach().cpu() for k, v in model.state_dict().items()}
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
    if launches != 1:
        raise AssertionError(f"the main path launched K1 {launches} times, not once")

    t_frames = 1 + CLIP_SECONDS * sr // cfg.features.hop_length
    classes = out.classes
    if classes.shape != (t_frames, cfg.grid.n_cells):
        raise AssertionError(f"class grid shape {classes.shape}")
    if classes.min() < 0 or classes.max() >= cfg.grid.num_classes:
        raise AssertionError(f"classes outside [0, {cfg.grid.num_classes - 1}]")

    from seld_tpu_torch.data.corpus import compute_mel_features

    # K1 reads the frames in place: the features' peak memory is the upload,
    # the padded waveform and two copies of the output; a framed copy of
    # the clip would add its 46 MB
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mel = compute_mel_features(wave, cfg.features, dev)
    torch.cuda.synchronize()
    feat_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    nf = cfg.features.n_fft
    framed_mb = 4 * wave.shape[0] * t_frames * nf / 1e6
    in_place_mb = 4 * wave.shape[0] * (2 * wave.shape[1] + nf + 2 * t_frames * mel.shape[-1]) / 1e6
    print(f"[flagship] compute_mel_features of the {CLIP_SECONDS} s clip: peak {feat_mb:.2f} MB "
          f"of device memory above the model's ({in_place_mb:.2f} MB without a framed copy, "
          f"{in_place_mb + framed_mb:.2f} MB with one)")
    if not feat_mb < in_place_mb + framed_mb / 2:
        raise AssertionError("compute_mel_features copied the frames")
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
    profile_call("predict", lambda: pred.predict_waveform(wave), clip_ms)
    return launches, phase_import(dev, pred, state_dict, cfg, wave)


def flax_variables(state_dict: dict, model_cfg) -> dict[str, np.ndarray]:
    """The port's state_dict -> the seld_tpu variables it came from, as
    {"params/<path>/<leaf>" or "batch_stats/<path>/<leaf>": numpy}: the
    inverse of seld_tpu_torch.convert.state_dict_from_jax for the layer
    kinds of a grid backbone without a GRU."""
    from seld_tpu_torch.convert import _LAYERS

    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    out = {}
    for jax_path, port, kind in _LAYERS[model_cfg.model_type](model_cfg):
        def put(leaf, value, collection="params"):
            out[f"{collection}/{jax_path}/{leaf}"] = np.ascontiguousarray(value)

        w = sd.get(f"{port}.weight")
        if kind in ("conv", "conv_bias"):
            put("kernel", w.transpose(2, 3, 1, 0))
        elif kind == "dense":
            put("kernel", w.T)
        elif kind == "depthwise":
            put("kernel", w.transpose(2, 1, 0))
        elif kind == "logits":
            m, g = model_cfg.num_classes, w.shape[0] // model_cfg.num_classes
            put("kernel", w.T.reshape(-1, m, g))
            put("bias", sd[f"{port}.bias"].reshape(m, g))
        elif kind in ("ln", "bn"):
            put("scale", w)
        else:
            raise ValueError(f"no inverse for layer kind {kind!r}")
        if kind in ("conv_bias", "dense", "depthwise", "ln", "bn"):
            put("bias", sd[f"{port}.bias"])
        if kind == "bn":
            put("mean", sd[f"{port}.running_mean"], "batch_stats")
            put("var", sd[f"{port}.running_var"], "batch_stats")
    return out


def reference_state_dict(variables: dict, model_cfg, num_classes: int) -> dict[str, np.ndarray]:
    """seld_tpu variables ({"params/<path>/<leaf>": ...}, as flax_variables
    gives them) -> the state_dict of the reference PyTorch pipeline's model:
    the inverse of seld_tpu_torch/tools/torch_import.py, under the key names
    its functions read. Of a GRU's r and z biases the whole sum goes into
    bias_ih and zeros into bias_hh, which the import folds back."""
    v = dict(variables)
    ref = {}

    def take(collection, path):
        return np.asarray(v.pop(f"{collection}/{path}"), np.float32)

    def conv2d(prefix, tp, bias=False):
        ref[f"{tp}.weight"] = take("params", f"{prefix}/kernel").transpose(3, 2, 0, 1)
        if bias:
            ref[f"{tp}.bias"] = take("params", f"{prefix}/bias")

    def linear(prefix, tp):
        ref[f"{tp}.weight"] = take("params", f"{prefix}/kernel").T
        ref[f"{tp}.bias"] = take("params", f"{prefix}/bias")

    def norm(prefix, tp):
        ref[f"{tp}.weight"] = take("params", f"{prefix}/scale")
        ref[f"{tp}.bias"] = take("params", f"{prefix}/bias")

    def bn(prefix, tp):
        norm(prefix, tp)
        ref[f"{tp}.running_mean"] = take("batch_stats", f"{prefix}/mean")
        ref[f"{tp}.running_var"] = take("batch_stats", f"{prefix}/var")
        ref[f"{tp}.num_batches_tracked"] = np.array(100, np.int64)

    def cnn_encoder():
        for i in range(len(model_cfg.crnn_cnn_channels)):
            conv2d(f"CNNEncoder_0/ConvBlock_{i}/Conv_0", f"cnn_blocks.{i}.conv")
            bn(f"CNNEncoder_0/ConvBlock_{i}/BatchNorm_0", f"cnn_blocks.{i}.bn")

    def grid_head(tp):
        linear("GridHead_0/Dense_0", f"{tp}.0")
        norm("GridHead_0/LayerNorm_0", f"{tp}.1")
        kernel = take("params", "GridHead_0/logits/kernel")  # (hidden, M, G)
        ref[f"{tp}.4.weight"] = kernel.transpose(0, 2, 1).reshape(kernel.shape[0], -1).T
        ref[f"{tp}.4.bias"] = take("params", "GridHead_0/logits/bias").T.reshape(-1)

    def conformer_blocks(n):
        for i in range(n):
            tb, fb = f"conformer_blocks.{i}", f"block_{i}"
            for ff_t, ff_f in (("ff1", "FeedForward_0"), ("ff2", "FeedForward_1")):
                linear(f"{fb}/{ff_f}/Dense_0", f"{tb}.{ff_t}.linear1")
                linear(f"{fb}/{ff_f}/Dense_1", f"{tb}.{ff_t}.linear2")
                norm(f"{fb}/{ff_f}/LayerNorm_0", f"{tb}.{ff_t}.norm")
            for w in ("w_q", "w_k", "w_v", "w_o"):
                linear(f"{fb}/MultiHeadSelfAttention_0/{w}", f"{tb}.attn.{w}")
            norm(f"{fb}/MultiHeadSelfAttention_0/LayerNorm_0", f"{tb}.attn.norm")
            cm = f"{fb}/ConformerConvModule_0"
            norm(f"{cm}/LayerNorm_0", f"{tb}.conv.layer_norm")
            for dense, conv in (("Dense_0", "pointwise_conv1"), ("Dense_1", "pointwise_conv2")):
                kernel = take("params", f"{cm}/{dense}/kernel")  # (I, O) -> (O, I, 1)
                ref[f"{tb}.conv.{conv}.weight"] = kernel.T[..., None]
                ref[f"{tb}.conv.{conv}.bias"] = take("params", f"{cm}/{dense}/bias")
            ref[f"{tb}.conv.depthwise_conv.weight"] = take(
                "params", f"{cm}/depthwise/kernel").transpose(2, 1, 0)
            ref[f"{tb}.conv.depthwise_conv.bias"] = take("params", f"{cm}/depthwise/bias")
            bn(f"{cm}/BatchNorm_0", f"{tb}.conv.batch_norm")
            norm(f"{fb}/LayerNorm_0", f"{tb}.norm")

    def gru(prefix, suffix):
        gates = "rzn"
        ref[f"rnn.weight_ih_{suffix}"] = np.concatenate(
            [take("params", f"{prefix}/i{g}/kernel").T for g in gates])
        ref[f"rnn.weight_hh_{suffix}"] = np.concatenate(
            [take("params", f"{prefix}/h{g}/kernel").T for g in gates])
        ref[f"rnn.bias_ih_{suffix}"] = np.concatenate(
            [take("params", f"{prefix}/i{g}/bias") for g in gates])
        b_hn = take("params", f"{prefix}/hn/bias")
        ref[f"rnn.bias_hh_{suffix}"] = np.concatenate([np.zeros_like(b_hn)] * 2 + [b_hn])

    def conv_bn_silu(prefix, tp):
        conv2d(f"{prefix}/Conv_0", f"{tp}.conv")
        bn(f"{prefix}/BatchNorm_0", f"{tp}.bn")

    kind = model_cfg.model_type
    if kind == "resnet_conformer":
        enc = "ResNet50Encoder_0"
        conv2d(f"{enc}/stem", "encoder.conv1")
        bn(f"{enc}/stem_bn", "encoder.bn1")
        for stage, blocks in enumerate((3, 4, 6, 3), start=1):
            for b in range(blocks):
                tb, fb = f"encoder.layer{stage}.{b}", f"{enc}/stage{stage}_block{b}"
                for c in (1, 2, 3):
                    conv2d(f"{fb}/conv{c}", f"{tb}.conv{c}")
                    bn(f"{fb}/bn{c}", f"{tb}.bn{c}")
                if f"params/{fb}/downsample/kernel" in v:
                    conv2d(f"{fb}/downsample", f"{tb}.downsample.0")
                    bn(f"{fb}/downsample_bn", f"{tb}.downsample.1")
        linear("proj", "proj")
        conformer_blocks(model_cfg.resnet_conf_n_layers)
        grid_head("head")
    elif kind in ("crnn", "conformer"):
        cnn_encoder()
        if kind == "crnn":
            for layer in range(model_cfg.crnn_rnn_layers):
                gru(f"BiGRU_0/GRUCell_{2 * layer}", f"l{layer}")
                gru(f"BiGRU_0/GRUCell_{2 * layer + 1}", f"l{layer}_reverse")
        else:
            linear("proj", "proj")
            conformer_blocks(model_cfg.conf_n_layers)
        grid_head("fnn")
    elif kind in ("cnn", "cspdarknet"):
        conv_bn_silu("backbone/stem", "backbone.stem")
        for s in range(4):
            ts, c3 = f"backbone.stage{s + 1}", f"backbone/c3_{s}"
            conv_bn_silu(f"backbone/down{s}", f"{ts}.0")
            for cv in ("cv1", "cv2", "cv3"):
                conv_bn_silu(f"{c3}/{cv}", f"{ts}.1.{cv}")
            i = 0
            while f"params/{c3}/m{i}/ConvBnSiLU_0/Conv_0/kernel" in v:
                conv_bn_silu(f"{c3}/m{i}/ConvBnSiLU_0", f"{ts}.1.m.{i}.cv1")
                conv_bn_silu(f"{c3}/m{i}/ConvBnSiLU_1", f"{ts}.1.m.{i}.cv2")
                i += 1
        for cv in ("cv1", "cv2"):
            conv_bn_silu(f"backbone/sppf/{cv}", f"backbone.stage4.2.{cv}")
        for p in ("p3", "p4", "p5"):
            conv2d(f"reduce_{p}", f"reduce_{p}", bias=True)
        conv2d("fuse1/Conv_0", "conv_fuse.0")
        bn("fuse1/BatchNorm_0", "conv_fuse.1")
        conv2d("fuse2/Conv_0", "conv_fuse.3")
        bn("fuse2/BatchNorm_0", "conv_fuse.4")
        linear("cls1", "classifier.0")
        norm("LayerNorm_0", "classifier.1")
        linear("cls2", "classifier.4")
    else:
        raise ValueError(f"the reference pipeline has no {kind!r}")
    if v:
        raise KeyError(f"variables the reference layout does not take: {sorted(v)[:5]}")
    return {k: np.ascontiguousarray(x) for k, x in ref.items()}


GUID_TAIL = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"  # KSDATAFORMAT_SUBTYPE


def write_float_wav(path: Path, wave: np.ndarray, sr: int, extensible: bool) -> None:
    """wave (C, N) as a float32 WAV: WAVE_FORMAT_IEEE_FLOAT, or
    WAVE_FORMAT_EXTENSIBLE with the IEEE-float SubFormat."""
    c = wave.shape[0]
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else 3, c, sr, sr * c * 4, c * 4, 32)
    if extensible:
        fmt += struct.pack("<HHIH", 22, 32, 0, 3) + GUID_TAIL
    data = np.ascontiguousarray(wave.T, dtype="<f4").tobytes()
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def phase_import(dev: torch.device, pred, state_dict: dict, cfg, wave: np.ndarray) -> dict:
    """The reference pipeline's checkpoint of the flagship's weights (a
    reference-layout .pth written by reference_state_dict) through `cli
    import-torch`; the imported checkpoint equal to the weights tensor for
    tensor; `cli predict` of the clip written as a float32 WAV and as an
    EXTENSIBLE float32 WAV from the imported checkpoint: K1 once each, the
    CSV (every active cell of the class grid) equal to that of
    pred.predict_waveform on the in-memory clip (the same weights loaded in
    process); the imported checkpoint's predict timed. Returns its numbers."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.data.audio import decode_wav
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.train.checkpoint import load_checkpoint

    sr = cfg.features.sample_rate
    want = pred.predict_waveform(wave).classes
    found, grids = {}, []
    predict_file = SELDPredictor.predict_file

    def recorded(self, *args, **kwargs):  # the class grid behind the CLI's CSV
        out = predict_file(self, *args, **kwargs)
        grids.append(out.classes)
        return out

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        ref = reference_state_dict(flax_variables(state_dict, cfg.model), cfg.model,
                                   cfg.grid.num_classes)
        torch.save({"model_state_dict": {k: torch.from_numpy(x) for k, x in ref.items()},
                    "epoch": 3, "test_loss": 0.25}, tmp / "reference.pth")
        t0 = time.perf_counter()
        if cli.main(["import-torch", "--torch-checkpoint", str(tmp / "reference.pth"),
                     f"data.base_path={tmp / 'run'}"]) != 0:
            raise AssertionError("cli import-torch failed")
        found["import_s"] = time.perf_counter() - t0
        best = tmp / "run" / "checkpoints" / "best" / "epoch_0003.pt"
        _, imported, epoch = load_checkpoint(best)
        differ = [k for k, t in state_dict.items() if not torch.equal(imported[k], t.cpu())]
        if epoch != 3 or imported.keys() != state_dict.keys() or differ:
            raise AssertionError(f"cli import-torch: epoch {epoch}, tensors that differ "
                                 f"{differ[:5]}")
        for tag, extensible in (("float32", False), ("EXTENSIBLE float32", True)):
            path = tmp / f"clip_{'ext' if extensible else 'f32'}.wav"
            write_float_wav(path, wave, sr, extensible)
            if not np.array_equal(decode_wav(path)[0], wave):
                raise AssertionError(f"the {tag} WAV does not decode to the clip")
            reset_launches()
            SELDPredictor.predict_file = recorded
            try:
                t0 = time.perf_counter()
                rc = cli.main(["predict", "--checkpoint", str(best), "--wavs", str(path),
                               "--out", str(tmp / tag)])
                cli_ms = (time.perf_counter() - t0) * 1e3
            finally:
                SELDPredictor.predict_file = predict_file
            counts = launches()
            csv = tmp / tag / "predictions" / f"{path.stem}.csv"
            same = np.array_equal(grids[-1], want)
            if rc != 0 or counts != only(k1=1) or not csv.exists() or not same:
                raise AssertionError(f"cli predict of the imported checkpoint, {tag} WAV: rc "
                                     f"{rc}, launches {counts}, the class grid "
                                     f"{'equals' if same else 'differs from'} the in-process one")
            found[f"cli_predict_ms {tag}"] = cli_ms
        imported_pred = SELDPredictor(best, batch_windows=pred.batch_windows, device=dev)
        imported_pred.predict_waveform(wave)  # warm-up
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            imported_pred.predict_waveform(wave)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        found["predict_ms"] = float(np.median(times))
    print(f"[import] cli import-torch of a reference-layout .pth of the flagship's weights: "
          f"{found['import_s']:.2f} s, every tensor equal; cli predict from the imported "
          f"checkpoint of the {CLIP_SECONDS} s clip as a float32 WAV "
          f"({found['cli_predict_ms float32']:.1f} ms) and as an EXTENSIBLE float32 WAV "
          f"({found['cli_predict_ms EXTENSIBLE float32']:.1f} ms): K1 1 launch each, the "
          f"class grid {want.shape} equal to predict_waveform's of the in-memory clip with the "
          f"same weights loaded in process, bit for bit; the imported "
          f"checkpoint's predict_waveform {found['predict_ms']:.2f} ms (median of "
          f"{', '.join(f'{t:.2f}' for t in times)})")
    return found


def profile_call(what: str, fn, median_ms: float) -> None:
    """One call of fn under torch.profiler: the device's busy share (kernel
    time over wall time) and the kernel time by family and by name.
    median_ms is the unprofiled median of the same call."""
    from torch.profiler import ProfilerActivity, profile

    tag = f"[profile {what}]"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events that are kernels or copies, not the profiler's own
    # annotation ranges (e.g. "Optimizer.step#Adam.step")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_name, by_family, counts = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in kernels:
        fam = next((f for f, pat in FAMILIES if re.search(pat, e.name, re.I)), "other")
        by_name[e.name] += e.device_time_total / 1e3
        by_family[fam] += e.device_time_total / 1e3
        counts[fam] += 1
    busy_ms = sum(by_name.values())
    print(f"{tag} profiled {what} {wall_ms:.2f} ms wall; {len(kernels)} kernel launches, "
          f"{busy_ms:.2f} ms of kernel time: device busy {100 * busy_ms / wall_ms:.1f} % of the "
          f"profiled {what}, {100 * busy_ms / median_ms:.1f} % of the unprofiled median")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"{tag}   {fam:28s} {ms:8.3f} ms  {counts[fam]:5d} launches")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"{tag}   top {ms:8.3f} ms  {name[:100]}")


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

    # a float32 train step keeps TF32 off through its backward too
    from seld_tpu_torch.losses import SELDLossFn
    from seld_tpu_torch.train.optimizer import make_optimizer
    from seld_tpu_torch.train.state import create_train_state
    from seld_tpu_torch.train.steps import make_train_step

    small = Config(model=ModelConfig(compute_dtype="float32", resnet_conf_n_layers=1))
    model = build_model(small.model, small.grid, device=dev, seed=2)
    optimizer = make_optimizer(model.parameters(), 1e-3)
    step = make_train_step(model, SELDLossFn(small.loss, small.grid), optimizer,
                           small.grid.num_classes)
    seen = []
    model.proj.register_full_backward_pre_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    mel = x.to(dev)[:, :50].repeat(2, 1, 1, 1)
    mask = torch.zeros((2, 50, small.grid.n_cells), dtype=torch.int16, device=dev)
    _, metrics = step(create_train_state(model, optimizer), mel, mask, None, (0, 1))
    after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if seen != [(False, False)] or after != before or not torch.isfinite(metrics["loss"]):
        raise AssertionError(f"float32 train step: TF32 {seen} in the backward, "
                             f"{before} -> {after}, loss {metrics['loss'].item()}")
    print(f"[f32] float32 train step: TF32 off in the backward, restored after; "
          f"loss {metrics['loss'].item():.6f}")


def phase_train(dev: torch.device, run_dir: Path) -> dict:
    """The training main path through the CLI under run_dir (kept for
    phase 14's calibration), then resume and serving. Returns the launch
    counts of the first (counted) run."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.config import Config
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops.loss_cuda import grid_loss_terms
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames
    from seld_tpu_torch.train.checkpoint import load_checkpoint

    cfg = Config()
    epochs = 2
    # cli train --synthetic: 2 x 30 s train clips, 1 x 20 s test clip
    hop = cfg.window.hop_frames(cfg.features)
    fps = cfg.features.sample_rate // cfg.features.hop_length
    train_steps = -(-(2 * 30 * fps // hop) // cfg.train.batch_size)
    eval_steps = -(-(20 * fps // hop) // cfg.train.batch_size)
    (ROOT / "build").mkdir(exist_ok=True)
    with contextlib.nullcontext(str(run_dir)) as tmp:
        args = ["train", "--synthetic", f"data.base_path={tmp}",
                "train.save_every_n_epochs=1"]
        grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
        log_mel_frames.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if cli.main([*args, f"train.num_epochs={epochs}"]) != 0:
            raise AssertionError("cli train failed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {"k2_fwd": grid_loss_terms.fwd_launches,
                  "k2_bwd": grid_loss_terms.bwd_launches, "k1": log_mel_frames.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        want = {"k2_fwd": epochs * (train_steps + eval_steps), "k2_bwd": epochs * train_steps,
                "k1": 3}
        if counts != want:
            raise AssertionError(f"kernel launches on the training path {counts}, expected {want}")

        work = Path(tmp) / "checkpoints"
        records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
        losses = [r[split][k] for r in records for split in ("train", "test") for k in r[split]]
        if len(records) != epochs or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"metrics.jsonl: {records}")
        best = sorted((work / "best").glob("epoch_*.pt"))
        rolling = sorted((work / "rolling").glob("epoch_*.pt"))
        if len(best) != 1 or len(rolling) != epochs or not (work / "training_history.json").exists():
            raise AssertionError(f"artifacts: best {best}, rolling {rolling}")
        _, trained, best_epoch = load_checkpoint(best[0])
        fresh = build_model(cfg.model, cfg.grid, device="cpu", seed=cfg.train.seed).state_dict()
        moved = [k for k in fresh if not torch.equal(fresh[k], trained[k])]
        if not (any(k.endswith("weight") for k in moved)
                and any(k.endswith("running_mean") for k in moved)
                and any(k.endswith("running_var") for k in moved)):
            raise AssertionError("parameters or BatchNorm statistics did not move")
        print(f"[train] cli train --synthetic, {epochs} epochs x ({train_steps} train + "
              f"{eval_steps} eval steps) in {wall_s:.1f} s with corpus build and checkpoints: "
              f"K2 forward {counts['k2_fwd']} launches, backward {counts['k2_bwd']}, K1 "
              f"{counts['k1']}; epoch seconds {[r['seconds'] for r in records]}; losses "
              f"{[round(r['train']['loss'], 6) for r in records]} train, "
              f"{[round(r['test']['loss'], 6) for r in records]} test; best epoch {best_epoch}; "
              f"{len(moved)} of {len(fresh)} tensors moved; peak device memory {peak_gib:.2f} GiB")

        stored_lr = torch.load(rolling[-1], weights_only=True)["optimizer"]["param_groups"][0]["lr"]
        grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
        if cli.main(["train", "--resume", *args[1:], f"train.num_epochs={epochs + 1}"]) != 0:
            raise AssertionError("cli train --resume failed")
        records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
        resumed = (grid_loss_terms.fwd_launches, grid_loss_terms.bwd_launches)
        if ([r["epoch"] for r in records] != [1, 2, 3] or records[-1]["lr"] != stored_lr
                or resumed != (train_steps + eval_steps, train_steps)):
            raise AssertionError(f"resume: records {records}, stored lr {stored_lr}, "
                                 f"K2 launches {resumed}")
        print(f"[train] --resume continued at epoch {records[-1]['epoch']} with the stored lr "
              f"{stored_lr}; K2 launches {resumed}")

        pred = SELDPredictor(sorted((work / "best").glob("epoch_*.pt"))[0], device=dev)
    sr = cfg.features.sample_rate
    wave = (0.1 * np.random.default_rng(3).standard_normal((4, 10 * sr))).astype(np.float32)
    classes = pred.predict_waveform(wave).classes
    if (classes.shape != (1 + 10 * fps, cfg.grid.n_cells) or classes.min() < 0
            or classes.max() >= cfg.grid.num_classes):
        raise AssertionError(f"serving the trained checkpoint: classes {classes.shape}")
    print(f"[train] SELDPredictor on the best checkpoint (epoch {pred.epoch}): 10 s clip -> "
          f"classes {classes.shape}")
    time_train_steps(dev, cfg)
    return counts


def time_train_steps(dev: torch.device, cfg, tag: str = "[train]", qat: bool = False,
                     distill=None, profile: bool = True) -> dict:
    """Wall time of cfg's train steps on seeded synthetic batches (host
    clock around a step that ends in a synchronize), K3's and K2's launches
    in one more step, and one step under torch.profiler (unless not
    `profile`). An ACCDOA model trains on the corpus's ACCDOA targets with
    its own loss and ACS hook; qat=True makes the steps quantization-aware
    (int8 fake-quant); distill (a DistillSpec) makes them distilling.
    Returns the losses of the timed steps, the metrics of the first, the
    median step ms, the peak device memory in GiB, those K3 counts and the
    K2 counts."""
    from seld_tpu_torch.accdoa import ACCDOALossFn, ADPITLossFn
    from seld_tpu_torch.data.sampler import BatchIterator, place_batch
    from seld_tpu_torch.data.synthetic import synthetic_corpus
    from seld_tpu_torch.features.acs import make_acs_augment, make_acs_augment_accdoa
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.features.specaugment import make_spec_augment
    from seld_tpu_torch.losses import SELDLossFn
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.models.registry import ACCDOA_MODELS, MULTI_ACCDOA_MODELS
    from seld_tpu_torch.ops.flash_attention import flash_attention as fa
    from seld_tpu_torch.ops.loss_cuda import grid_loss_terms
    from seld_tpu_torch.train.optimizer import make_optimizer
    from seld_tpu_torch.train.state import create_train_state
    from seld_tpu_torch.train.steps import make_train_step

    accdoa = cfg.model.model_type in ACCDOA_MODELS
    multi = cfg.model.model_type in MULTI_ACCDOA_MODELS
    corpus = synthetic_corpus(cfg, n_files=2, seconds=30.0, seed=0, device=dev)
    model = build_model(cfg.model, cfg.grid, device=dev, seed=0,
                        in_channels=feature_channels(cfg.features.feature_set,
                                                     cfg.model.n_channels))
    optimizer = make_optimizer(model.parameters(), cfg.train.learning_rate,
                               cfg.train.weight_decay)
    spatial_augment = None
    if cfg.train.acs_augment:
        spatial_augment = (make_acs_augment_accdoa(cfg.features.feature_set, multi) if accdoa
                           else make_acs_augment(cfg.grid.n_el, cfg.grid.n_az,
                                                 cfg.features.feature_set))
    loss_fn = ((ADPITLossFn() if multi else ACCDOALossFn()) if accdoa
               else SELDLossFn(cfg.loss, cfg.grid))
    step = make_train_step(model, loss_fn, optimizer,
                           cfg.grid.num_classes, input_augment=make_spec_augment(cfg.train),
                           spatial_augment=spatial_augment, qat=qat, distill=distill)
    state = create_train_state(model, optimizer)
    batches = [(p[0], p[3] if accdoa else p[1], p[2]) for p in (
        place_batch(b, dev) for b in BatchIterator(corpus, cfg.train.batch_size))][:3]
    times, losses, first = [], [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(13):
        mel, mask, em = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, mel, mask, em, (0, 1))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        first = first or {k: v.item() for k, v in metrics.items()}
    steady = times[3:]
    step_ms = float(np.median(steady))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    mel, mask, em = batches[0]
    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
    step(state, mel, mask, em, (0, 1))
    torch.cuda.synchronize()
    k3 = {"k3_fwd": fa.fwd_launches, "k3_dq": fa.bwd_dq_launches,
          "k3_dkv": fa.bwd_dkv_launches}
    k2 = {"k2_fwd": grid_loss_terms.fwd_launches, "k2_bwd": grid_loss_terms.bwd_launches}
    print(f"{tag} train step, batch {cfg.train.batch_size} x {corpus.window_frames} frames "
          f"x {corpus.mel.shape[1]} feature channels, {cfg.model.compute_dtype}: median "
          f"{step_ms:.2f} ms of {', '.join(f'{t:.1f}' for t in steady)} (first "
          f"three, with warm-up: {', '.join(f'{t:.1f}' for t in times[:3])}) = "
          f"{cfg.train.batch_size / (step_ms * 1e-3):.1f} windows/s; peak device memory "
          f"{peak_gib:.2f} GiB; K3 launches in one step: forward {k3['k3_fwd']}, dQ "
          f"{k3['k3_dq']}, dK/dV {k3['k3_dkv']}")
    what = tag.strip("[]").replace("][", " ")
    if profile:
        profile_call("train step" if tag == "[train]" else f"{what} train step",
                     lambda: step(state, mel, mask, em, (0, 1)), step_ms)
    return {"losses": losses, "first": first, "step_ms": step_ms, "peak_gib": peak_gib,
            "k3": k3, "k2": k2}


def phase_long_window(dev: torch.device) -> dict:
    """The long-window path at full width: 20 s windows are T = 1000 frames,
    so every conformer block's attention runs through K3. Serve, train
    through the CLI with a loss-component dashboard (one more eval forward),
    evaluate through the CLI with its default 5 prediction PNGs (one more
    forward of their windows), replot the run's loss curves; returns K3's
    launch counts of the training run, with those of the two forwards
    under "k3_fwd_viz". Without matplotlib nothing is drawn: see phase 7
    in the module's docstring."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.config import Config, WindowConfig
    from seld_tpu_torch.data.synthetic import synthetic_corpus
    from seld_tpu_torch.eval import evaluate
    from seld_tpu_torch.tools import replot
    from seld_tpu_torch.train import trainer
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops.flash_attention import flash_attention as fa
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    def k3_counts():
        return {"k3_fwd": fa.fwd_launches, "k3_dq": fa.bwd_dq_launches,
                "k3_dkv": fa.bwd_dkv_launches}

    def k3_reset():
        fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0

    viz_launches = {}

    @contextlib.contextmanager
    def k3_fwd_inside(module, name: str, label: str):
        """module.name wrapped for the block: K3's forward launches inside
        its calls are added up under viz_launches[label]."""
        inner = getattr(module, name)

        def wrapped(*args, **kwargs):
            before = fa.fwd_launches
            out = inner(*args, **kwargs)
            viz_launches[label] = viz_launches.get(label, 0) + fa.fwd_launches - before
            return out

        setattr(module, name, wrapped)
        try:
            yield
        finally:
            setattr(module, name, inner)

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    cfg = Config(window=WindowConfig(window_seconds=LONG_WINDOW_SECONDS))
    win = cfg.window.window_frames(cfg.features)
    blocks = cfg.model.resnet_conf_n_layers
    sr = cfg.features.sample_rate
    fps = sr // cfg.features.hop_length
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # serve
        model = build_model(cfg.model, cfg.grid, device=dev, seed=0)
        save_checkpoint(Path(tmp) / "long.pt", model, cfg)
        del model
        pred = SELDPredictor(Path(tmp) / "long.pt", batch_windows=8, device=dev)
        wave = (0.1 * np.random.default_rng(0).standard_normal((4, CLIP_SECONDS * sr))
                ).astype(np.float32)
        pred.predict_waveform(wave)  # warm-up
        torch.cuda.synchronize()
        k3_reset()
        torch.cuda.reset_peak_memory_stats()
        classes = pred.predict_waveform(wave).classes
        torch.cuda.synchronize()
        t_frames = 1 + CLIP_SECONDS * fps
        forwards = -(-(-(-t_frames // win)) // pred.batch_windows)
        served = k3_counts()
        if served != {"k3_fwd": forwards * blocks, "k3_dq": 0, "k3_dkv": 0}:
            raise AssertionError(f"serving at T={win}: K3 launches {served}, expected "
                                 f"{forwards * blocks} forward")
        if (classes.shape != (t_frames, cfg.grid.n_cells) or classes.min() < 0
                or classes.max() >= cfg.grid.num_classes):
            raise AssertionError(f"serving at T={win}: classes {classes.shape}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            pred.predict_waveform(wave)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        clip_ms = float(np.median(times))
        print(f"[long] SELDPredictor at {LONG_WINDOW_SECONDS:g} s windows (T = {win}), bf16: "
              f"{CLIP_SECONDS} s clip -> classes {classes.shape}; {forwards} forward of "
              f"{pred.batch_windows} windows, K3 forward {served['k3_fwd']} launches; "
              f"{clip_ms:.2f} ms per clip (median of {', '.join(f'{x:.2f}' for x in times)}) = "
              f"{CLIP_SECONDS / (clip_ms * 1e-3):.1f} audio-s/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_call("long predict", lambda: pred.predict_waveform(wave), clip_ms)
        del pred

        # train: cli train --synthetic builds 2 x 30 s train clips and a 20 s
        # test clip; windows start every hop, so their count does not depend
        # on the window length
        hop = cfg.window.hop_frames(cfg.features)
        train_steps = -(-(2 * 30 * fps // hop) // cfg.train.batch_size)
        eval_steps = -(-(20 * fps // hop) // cfg.train.batch_size)
        args = ["--synthetic", f"data.base_path={tmp}",
                f"window.window_seconds={LONG_WINDOW_SECONDS}", "train.num_epochs=1",
                "train.save_every_n_epochs=1", "train.viz_loss_components_every=1",
                f"train.profile_steps={PROFILE_STEPS}"]
        k3_reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with (log_messages("seld_tpu_torch.train.trainer") as logged,
              k3_fwd_inside(trainer, "_loss_dashboard", "train dashboard")):
            if cli.main(["train", *args]) != 0:
                raise AssertionError("cli train at long windows failed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = k3_counts()
        # the dashboard's eval forward of the first test batch: once per block
        want = {"k3_fwd": (train_steps + eval_steps + 1) * blocks,
                "k3_dq": train_steps * blocks, "k3_dkv": train_steps * blocks}
        if counts != want or viz_launches != {"train dashboard": blocks}:
            raise AssertionError(f"K3 launches on the long-window training path {counts}, "
                                 f"expected {want}; in the dashboard {viz_launches}, "
                                 f"expected {blocks}")
        counts["trace"] = profile_tool(Path(tmp) / "outputs" / "profile", blocks)
        work = Path(tmp) / "checkpoints"
        (record,) = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
        if not all(math.isfinite(record[s]["loss"]) for s in ("train", "test")):
            raise AssertionError(f"long-window metrics.jsonl: {record}")
        outputs = Path(tmp) / "outputs"
        (dash,) = [m for m in logged if "Loss-component dashboard: forward" in m]
        dash_ms = float(re.search(r"([\d.]+) ms", dash).group(1))
        if have_mpl:
            pngs = [outputs / "loss_curves.png", *sorted(
                (outputs / "train_visualizations").glob("loss_components_epoch1_f*.png"))]
            if len(pngs) != 2 or not all(decodes(p) for p in pngs):
                raise AssertionError(f"cli train PNGs at long windows: {pngs}")
            (rendered,) = [m for m in logged if "Loss-component dashboard rendered" in m]
            drawn = (f"rendering {float(re.search(r'([\d.]+) ms', rendered).group(1)):.1f} ms "
                     f"-> {pngs[1].name}; loss_curves.png")
        else:
            failed = [m for m in logged if "failed: No module named 'matplotlib'" in m]
            if len(failed) != 2 or list(outputs.rglob("*.png")):
                raise AssertionError(f"cli train without matplotlib: {failed}")
            drawn = "rendering not run: matplotlib is not installed on this machine"
        frame = re.search(r"batch \d+, frame \d+", dash).group(0)
        print(f"[viz] train loss-component dashboard at T = {win} (first test batch of "
              f"{cfg.train.batch_size} windows, {frame} chosen on the card): K3 forward "
              f"{viz_launches['train dashboard']} launches, forward and frame choice "
              f"{dash_ms:.1f} ms; {drawn}")
        print(f"[long] cli train --synthetic window.window_seconds={LONG_WINDOW_SECONDS:g}, 1 "
              f"epoch of {train_steps} train + {eval_steps} eval steps in {wall_s:.1f} s: K3 "
              f"forward {counts['k3_fwd']}, dQ {counts['k3_dq']}, dK/dV {counts['k3_dkv']} "
              f"launches; train loss {record['train']['loss']:.6f}, test "
              f"{record['test']['loss']:.6f}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # evaluate, with the default 5 prediction PNGs: one more forward
        k3_reset()
        printed = io.StringIO()
        with (log_messages("seld_tpu_torch.eval.evaluate") as logged,
              contextlib.redirect_stdout(printed),
              k3_fwd_inside(evaluate, "_visualize", "eval visualization pass")):
            rc = cli.main(["eval", *args[:3],
                           *([] if have_mpl else ["--num-visualizations", "0"])])
        report = printed_json(printed.getvalue())
        evaluated = k3_counts()
        if (rc != 0 or evaluated != {"k3_fwd": (eval_steps + int(have_mpl)) * blocks, "k3_dq": 0,
                                     "k3_dkv": 0}
                or viz_launches.get("eval visualization pass") != (blocks if have_mpl else None)
                or report["checkpoint_epoch"] != 1 or "SELD_error" not in report["dcase2022"]
                or not math.isfinite(report["test_loss"])):
            raise AssertionError(f"cli eval at long windows: rc {rc}, K3 {evaluated}, around "
                                 f"the visualization forwards {viz_launches}, report keys "
                                 f"{sorted(report)}")
        if abs(report["test_loss"] - record["test"]["loss"]) > 1e-4:
            raise AssertionError(f"cli eval test loss {report['test_loss']} != the trainer's "
                                 f"{record['test']['loss']} for the same checkpoint")
        print(f"[long] cli eval --synthetic: checkpoint epoch {report['checkpoint_epoch']} "
              f"({report['checkpoint_kind']}), test loss {report['test_loss']:.6f}, overall "
              f"accuracy {report['overall_accuracy']:.2f} %, DCASE2022 SELD_error "
              f"{report['dcase2022']['SELD_error']:.4f}; K3 forward {evaluated['k3_fwd']} "
              f"launches over {eval_steps} eval steps"
              + (" and the visualization forward" if have_mpl else ""))
        metrics = replot.load_metrics(work / "metrics.jsonl")
        if not have_mpl:
            print("[viz] eval visualization pass and tools.replot's PNG not run: matplotlib is "
                  "not installed on this machine (cli eval --num-visualizations 0)")
            print(f"[viz] tools.replot table of the run's metrics.jsonl:\n"
                  f"{replot.summarize(metrics)}")
        else:
            # the PNGs: min(5, frames with events), each of a frame with
            # events of the test clip (the CLI's seeded one)
            test_c = synthetic_corpus(cfg, n_files=1, seconds=20.0, seed=1, train=False,
                                      device=dev)
            named = {}
            for p in (outputs / "test_visualizations").glob("test_viz_*.png"):
                k, w, t = map(int, re.fullmatch(r"test_viz_(\d+)_window(\d+)_frame(\d+)\.png",
                                                p.name).groups())
                named[k] = (w, t, decodes(p), bool(test_c.gather([w])[1][0, t].any()))
            n_viz = min(5, report["num_frames_with_events"])
            if sorted(named) != list(range(1, n_viz + 1)) or not all(
                    ok and events for _, _, ok, events in named.values()):
                raise AssertionError(f"cli eval PNGs at long windows: {named}, expected {n_viz}")
            (saved,) = [m for m in logged if "prediction visualizations" in m]
            viz_ms = [float(x) for x in re.findall(r"([\d.]+) ms", saved)]
            n_windows = len({w for w, *_ in named.values()})
            print(f"[viz] eval visualization pass at T = {win}: {n_viz} PNGs of {n_windows} "
                  f"windows, K3 forward {viz_launches['eval visualization pass']} launches; "
                  f"forward {viz_ms[0]:.1f} ms, rendering {viz_ms[1]:.1f} ms "
                  f"({viz_ms[1] / n_viz:.1f} ms a PNG)")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                replot.main([str(work / "metrics.jsonl"), "--out", str(outputs / "replot.png")])
            replot_ms = (time.perf_counter() - t0) * 1e3
            if not decodes(outputs / "replot.png"):
                raise AssertionError("replot of the long-window run wrote no PNG")
            print(f"[viz] tools.replot of the run's metrics.jsonl ({len(metrics)} epoch): "
                  f"{replot_ms:.1f} ms (host only)")
    counts["k3_fwd_viz"] = dict(viz_launches)
    losses = time_train_steps(dev, cfg, tag="[long]")["losses"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"long-window train loss did not fall over the timed steps: {losses}")
    return counts, record["train"]["loss"]


PROFILE_STEPS = 2  # train.profile_steps of phase 7's cli train: steps 1 and 2 traced
# kernel names (substrings of CUDA's names in the trace) -> launches a train step
TRACED_KERNELS = (("grid_loss_fwd", "k2_fwd", 1), ("grid_loss_bwd", "k2_bwd", 1),
                  ("flash_fwd_wgmma", "k3_fwd", "blocks"), ("flash_dq_wgmma", "k3_dq", "blocks"),
                  ("flash_dkv_wgmma", "k3_dkv", "blocks"))


def profile_tool(trace_dir: Path, blocks: int) -> dict:
    """The trace that `train.profile_steps` wrote, read back by the port's
    tools.profile_summary: its top rows and categories in [profile-tool]
    lines, and K2's and K3's launches counted by kernel name, which must be
    exactly PROFILE_STEPS train steps' worth. Returns the counts."""
    from seld_tpu_torch.tools import profile_summary

    traces = sorted(trace_dir.glob("*.json"))
    rows, plane = profile_summary.summarize(trace_dir, top=8)
    cats = profile_summary.category_totals(trace_dir)
    by_name = profile_summary.event_counts(trace_dir)
    counts = {key: sum(n for name, n in by_name.items() if pattern in name)
              for pattern, key, _ in TRACED_KERNELS}
    want = {key: PROFILE_STEPS * (blocks if per == "blocks" else per)
            for _, key, per in TRACED_KERNELS}
    if len(traces) != 1 or not plane.startswith("/device:cuda") or counts != want:
        raise AssertionError(f"train.profile_steps={PROFILE_STEPS}: traces {traces}, plane "
                             f"{plane}, kernels by name {counts}, expected {want}")
    print(f"[profile-tool] {traces[0].name}: plane {plane}, {sum(by_name.values())} device "
          f"events; by kernel name {json.dumps(counts)} (= {PROFILE_STEPS} traced steps)")
    print(f"[profile-tool] categories {json.dumps({k: round(v, 3) for k, v in cats.items()})}")
    for ms, share, name in rows:
        print(f"[profile-tool]   {ms:8.3f} ms {100 * share:5.1f} %  {name[:90]}")
    return {**counts, "categories_ms": cats, "top": [(round(ms, 4), name[:80])
                                                     for ms, _, name in rows[:5]]}


def decodes(path: Path) -> bool:
    """Whether matplotlib decodes the PNG at path to a non-empty RGBA
    array."""
    from matplotlib import image as mpimg

    pixels = mpimg.imread(path)
    return pixels.ndim == 3 and pixels.shape[-1] == 4 and pixels.size > 0


RECIPE = ["features.feature_set=mel_iv", "train.acs_augment=true",
          "targets.use_gaussian_augmentation=true", "train.specaugment_time_masks=2",
          "train.specaugment_freq_masks=2"]


def write_starss_layout(root: Path, cfg, train_files: int, train_seconds: float,
                        test_seconds: float) -> None:
    """Seeded synthetic WAV and CSV files under root in the STARSS22 layout:
    train_files clips in dev-train-sony / dev-train-tau and one test clip
    in dev-test-sony."""
    from seld_tpu_torch.data.synthetic import synthetic_raw_files

    synthetic_raw_files(root, cfg, n_files=train_files, seconds=train_seconds, seed=0,
                        split_dirs=True)
    staging = root / "staging"
    synthetic_raw_files(staging, cfg, n_files=1, seconds=test_seconds, seed=1,
                        split_dirs=True)
    for sub in (cfg.data.audio_dirname, cfg.data.metadata_dirname):
        (staging / sub / "dev-train-sony").rename(root / sub / "dev-test-sony")
    shutil.rmtree(staging)


@contextlib.contextmanager
def log_messages(name: str):
    """The messages logged under logger `name` inside the block."""
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    log = logging.getLogger(name)
    log.addHandler(handler)
    try:
        yield messages
    finally:
        log.removeHandler(handler)


def phase_spatial(dev: torch.device) -> dict:
    """The accuracy recipe at full width: train through the CLI from WAV
    files (features through K4, the corpus cache), evaluate through the CLI
    (a cache hit), serve with "mel_iv" and with "mel_gcc"; returns K4's
    launch counts on that path."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops.loss_cuda import grid_loss_terms
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames
    from seld_tpu_torch.ops.spatial_cuda import spatial_features
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    cfg = parse_overrides(Config(), RECIPE)
    epochs = 2
    hop = cfg.window.hop_frames(cfg.features)
    fps = cfg.features.sample_rate // cfg.features.hop_length
    train_steps = -(-(2 * 30 * fps // hop) // cfg.train.batch_size)
    eval_steps = -(-(20 * fps // hop) // cfg.train.batch_size)
    sr = cfg.features.sample_rate
    wave = (0.1 * np.random.default_rng(0).standard_normal((4, CLIP_SECONDS * sr))
            ).astype(np.float32)
    t_frames = 1 + CLIP_SECONDS * fps
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        write_starss_layout(root, cfg, train_files=2, train_seconds=30.0, test_seconds=20.0)
        args = [f"data.base_path={root}", f"data.cache_dir={root / 'cache'}", *RECIPE,
                "train.save_every_n_epochs=2"]
        spatial_features.launches = log_mel_frames.launches = 0
        grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with log_messages("seld_tpu_torch") as logged:
            if cli.main(["train", *args, f"train.num_epochs={epochs}"]) != 0:
                raise AssertionError("cli train of the recipe failed")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {"k4": spatial_features.launches, "k1": log_mel_frames.launches,
                  "k2_fwd": grid_loss_terms.fwd_launches,
                  "k2_bwd": grid_loss_terms.bwd_launches}
        want = {"k4": 3, "k1": 0, "k2_fwd": epochs * (train_steps + eval_steps),
                "k2_bwd": epochs * train_steps}
        if counts != want:
            raise AssertionError(f"kernel launches on the recipe's training path {counts}, "
                                 f"expected {want}")
        stored = [m for m in logged if m.startswith("Corpus cache stored")]
        hooks = [m for m in logged if m.startswith(("SpecAugment on", "ACS spatial"))]
        work = root / "checkpoints"
        records = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
        losses = [r[split][k] for r in records for split in ("train", "test") for k in r[split]]
        best = sorted((work / "best").glob("epoch_*.pt"))
        if (len(stored) != 2 or len(hooks) != 2 or len(records) != epochs
                or not all(math.isfinite(v) for v in losses) or len(best) != 1
                or not list((work / "rolling").glob("epoch_*.pt"))
                or not (work / "training_history.json").exists()):
            raise AssertionError(f"recipe training: cache {stored}, hooks {hooks}, records "
                                 f"{records}, best {best}")
        print(f"[spatial] cli train {' '.join(RECIPE)} data.cache_dir=...: {epochs} epochs x "
              f"({train_steps} train + {eval_steps} eval steps) in {wall_s:.1f} s from 3 WAV "
              f"files: K4 {counts['k4']} launches, K1 {counts['k1']}, K2 forward "
              f"{counts['k2_fwd']}, backward {counts['k2_bwd']}; losses "
              f"{[round(r['train']['loss'], 6) for r in records]} train, "
              f"{[round(r['test']['loss'], 6) for r in records]} test; {len(stored)} cache "
              f"entries stored; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # evaluate: both corpora come from the cache
        spatial_features.launches = 0
        printed = io.StringIO()
        with log_messages("seld_tpu_torch") as logged, contextlib.redirect_stdout(printed):
            rc = cli.main(["eval", *args, "--num-visualizations", "0"])
        report = printed_json(printed.getvalue())
        hits = [m for m in logged if m.startswith("Corpus cache hit")]
        best_record = next(r for r in records if r["epoch"] == report["checkpoint_epoch"])
        if (rc != 0 or spatial_features.launches != 0 or len(hits) != 2
                or "SELD_error" not in report["dcase2022"]
                or abs(report["test_loss"] - best_record["test"]["loss"]) > 1e-4):
            raise AssertionError(f"cli eval of the recipe: rc {rc}, K4 "
                                 f"{spatial_features.launches}, hits {hits}, test loss "
                                 f"{report['test_loss']} against {best_record['test']['loss']}")
        print(f"[spatial] cli eval: {len(hits)} cache hits, K4 {spatial_features.launches} "
              f"launches; checkpoint epoch {report['checkpoint_epoch']}, test loss "
              f"{report['test_loss']:.6f} (the trainer's {best_record['test']['loss']:.6f}), "
              f"DCASE2022 SELD_error {report['dcase2022']['SELD_error']:.4f}")

        # serve: the trained mel_iv checkpoint, then a seeded mel_gcc flagship
        pred = SELDPredictor(best[0], batch_windows=8, device=dev)
        gcc_cfg = cfg.replace_path("features.feature_set", "mel_gcc")
        model = build_model(gcc_cfg.model, gcc_cfg.grid, device=dev, seed=0,
                            in_channels=feature_channels("mel_gcc"))
        save_checkpoint(root / "gcc.pt", model, gcc_cfg)
        del model
        gcc_pred = SELDPredictor(root / "gcc.pt", batch_windows=8, device=dev)
    from seld_tpu_torch.data.corpus import compute_mel_features

    served = {}
    for name, p in (("mel_iv", pred), ("mel_gcc", gcc_pred)):
        p.predict_waveform(wave)  # warm-up
        torch.cuda.synchronize()
        # K4 reads the frames in place: the features' peak memory is the
        # upload, the padded waveform and the output; a framed copy of the
        # clip would add its 46 MB
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        feats = compute_mel_features(wave, p.cfg.features, dev)
        torch.cuda.synchronize()
        feat_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
        n_fft = p.cfg.features.n_fft
        framed_mb = 4 * wave.shape[0] * t_frames * n_fft / 1e6
        in_place_mb = 4 * (wave.shape[0] * (2 * wave.shape[1] + n_fft) + feats.numel()) / 1e6
        print(f"[spatial] compute_mel_features {name} of the {CLIP_SECONDS} s clip: peak "
              f"{feat_mb:.2f} MB of device memory above the model's ({in_place_mb:.2f} MB "
              f"without a framed copy, {in_place_mb + framed_mb:.2f} MB with one)")
        if not feat_mb < in_place_mb + framed_mb / 2:
            raise AssertionError(f"compute_mel_features {name} copied the frames")
        del feats
        spatial_features.launches = 0
        classes = p.predict_waveform(wave).classes
        torch.cuda.synchronize()
        served[name] = spatial_features.launches
        if (served[name] != 1 or classes.shape != (t_frames, cfg.grid.n_cells)
                or classes.min() < 0 or classes.max() >= cfg.grid.num_classes):
            raise AssertionError(f"serving {name}: K4 {served[name]} launches, classes "
                                 f"{classes.shape}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            p.predict_waveform(wave)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        clip_ms = float(np.median(times))
        print(f"[spatial] SELDPredictor {name} ({feature_channels(name)} feature channels): "
              f"{CLIP_SECONDS} s clip -> classes {classes.shape}, K4 {served[name]} launch; "
              f"{clip_ms:.2f} ms per clip (median of {', '.join(f'{x:.2f}' for x in times)}) = "
              f"{CLIP_SECONDS / (clip_ms * 1e-3):.1f} audio-s/s")
        profile_call(f"{name} predict", lambda: p.predict_waveform(wave), clip_ms)
    del pred, gcc_pred
    losses = time_train_steps(dev, cfg, tag="[spatial]")["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"recipe train steps: losses {losses}")
    return {"mel_iv": counts["k4"], "mel_gcc": served["mel_gcc"]}


BACKBONES = (  # (model_type, overrides): full width, the JAX package's defaults
    ("crnn", ["model.model_type=crnn"]),
    ("conformer", ["model.model_type=conformer"]),
    ("cnn", ["model.model_type=cnn", "model.csp_use_small=true"]),
)


def serve_clip(pred, wave, tag: str, profile: bool = False) -> dict:
    """One counted predict of the 60 s clip (K1, K4, K3 forward counts),
    then five timed ones, and with `profile` one more under torch.profiler;
    checks the class grid."""
    from seld_tpu_torch.ops.flash_attention import flash_attention as fa
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames
    from seld_tpu_torch.ops.spatial_cuda import spatial_features

    pred.predict_waveform(wave)  # warm-up
    torch.cuda.synchronize()
    log_mel_frames.launches = fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    spatial_features.launches = 0
    torch.cuda.reset_peak_memory_stats()
    classes = pred.predict_waveform(wave).classes
    torch.cuda.synchronize()
    counts = {"k1": log_mel_frames.launches, "k4": spatial_features.launches,
              "k3_fwd": fa.fwd_launches, "k3_dq": fa.bwd_dq_launches,
              "k3_dkv": fa.bwd_dkv_launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    grid = pred.cfg.grid
    t_frames = 1 + CLIP_SECONDS * pred.cfg.features.sample_rate // pred.cfg.features.hop_length
    if (classes.shape != (t_frames, grid.n_cells) or classes.min() < 0
            or classes.max() >= grid.num_classes):
        raise AssertionError(f"{tag} serving: classes {classes.shape}")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred.predict_waveform(wave)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    clip_ms = float(np.median(times))
    print(f"{tag} SELDPredictor at {pred.cfg.window.window_seconds:g} s windows: "
          f"{CLIP_SECONDS} s clip -> classes {classes.shape}; K1 {counts['k1']}, K4 "
          f"{counts['k4']}, K3 forward {counts['k3_fwd']} launches; {clip_ms:.2f} ms per clip "
          f"(median of "
          f"{', '.join(f'{x:.2f}' for x in times)}) = {CLIP_SECONDS / (clip_ms * 1e-3):.1f} "
          f"audio-s/s; peak device memory {peak_gib:.2f} GiB")
    if profile:
        what = tag.strip("[]").replace("][", " ")
        profile_call(f"{what} predict", lambda: pred.predict_waveform(wave), clip_ms)
    return counts


def phase_backbones(dev: torch.device) -> dict:
    """The other grid backbones at full width (CRNN: channels 64-512, GRU
    hidden 256, 2 layers; Conformer: d_model 256, 4 heads, 2 blocks,
    kernel 31; CSPDarkNet small): `cli verify`, then for each `cli train
    --synthetic` for one epoch (batch 16, T = 250; K1 and K2 counted
    exactly), a 60 s predict from its best checkpoint (K1 once, K3 never),
    timed and profiled train steps; the Conformer also one train step
    (K3 forward, dQ and dK/dV once per block) and a 60 s predict at 20 s
    windows. Returns the launch counts of every run."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.ops.loss_cuda import grid_loss_terms
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames
    from seld_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["verify"])
    lines = [x for x in printed.getvalue().splitlines() if not LOG_LINE.match(x)]
    ok = [line.split(":")[0].strip() for line in lines if "OK |" in line]
    print("\n".join(f"[verify] {line}" for line in lines))
    if rc != 0 or ok != list(cli.VERIFY_BACKBONES):
        raise AssertionError(f"cli verify: rc {rc}, OK for {ok}")

    fps = Config().features.sample_rate // Config().features.hop_length
    sr = Config().features.sample_rate
    wave = (0.1 * np.random.default_rng(0).standard_normal((4, CLIP_SECONDS * sr))
            ).astype(np.float32)
    found = {}
    (ROOT / "build").mkdir(exist_ok=True)
    for name, overrides in BACKBONES:
        cfg = parse_overrides(Config(), overrides)
        hop = cfg.window.hop_frames(cfg.features)
        train_steps = -(-(2 * 30 * fps // hop) // cfg.train.batch_size)
        eval_steps = -(-(20 * fps // hop) // cfg.train.batch_size)
        tag = f"[{name}]"
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
            log_mel_frames.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if cli.main(["train", "--synthetic", f"data.base_path={tmp}", *overrides,
                         "train.num_epochs=1", "train.save_every_n_epochs=1"]) != 0:
                raise AssertionError(f"cli train {name} failed")
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = {"k2_fwd": grid_loss_terms.fwd_launches,
                      "k2_bwd": grid_loss_terms.bwd_launches, "k1": log_mel_frames.launches}
            want = {"k2_fwd": train_steps + eval_steps, "k2_bwd": train_steps, "k1": 3}
            if counts != want:
                raise AssertionError(f"{name}: launches on the training path {counts}, "
                                     f"expected {want}")
            work = Path(tmp) / "checkpoints"
            (record,) = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
            if not all(math.isfinite(record[s]["loss"]) for s in ("train", "test")):
                raise AssertionError(f"{name} metrics.jsonl: {record}")
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            best = sorted((work / "best").glob("epoch_*.pt"))[0]
            pred = SELDPredictor(best, batch_windows=8, device=dev)
            if pred.cfg.model.model_type != name:
                raise AssertionError(f"the predictor rebuilt {pred.cfg.model.model_type}")
            n_params = sum(p.numel() for p in pred.model.parameters())
            print(f"{tag} cli train --synthetic {' '.join(overrides)}: {n_params / 1e6:.2f} M "
                  f"parameters, 1 epoch of {train_steps} train + {eval_steps} eval steps in "
                  f"{wall_s:.1f} s; K2 forward {counts['k2_fwd']}, backward "
                  f"{counts['k2_bwd']}, K1 {counts['k1']} launches; train loss "
                  f"{record['train']['loss']:.6f}, test {record['test']['loss']:.6f}; peak "
                  f"device memory {peak_gib:.2f} GiB")
            served = serve_clip(pred, wave, tag)
            if served != {"k1": 1, "k4": 0, "k3_fwd": 0, "k3_dq": 0, "k3_dkv": 0}:
                raise AssertionError(f"{name} serving at T = 250: launches {served}")
            del pred
            found[name] = {"train": counts, "predict": served}
            if name == "conformer":  # 20 s windows: attention through K3
                long_cfg = cfg.replace_path("window.window_seconds", LONG_WINDOW_SECONDS)
                _, state, _ = load_checkpoint(best)
                save_checkpoint(Path(tmp) / "long.pt", state, long_cfg)
                pred = SELDPredictor(Path(tmp) / "long.pt", batch_windows=8, device=dev)
                served = serve_clip(pred, wave, f"{tag}[long]")
                win = long_cfg.window.window_frames(long_cfg.features)
                forwards = -(-(-(-(1 + CLIP_SECONDS * fps) // win)) // 8)
                blocks = long_cfg.model.conf_n_layers
                if served != {"k1": 1, "k4": 0, "k3_fwd": forwards * blocks, "k3_dq": 0,
                              "k3_dkv": 0}:
                    raise AssertionError(f"conformer serving at T = {win}: launches {served}")
                del pred
                found["conformer_long"] = {"predict": served}
        timed = time_train_steps(dev, cfg, tag=tag)
        if not all(math.isfinite(x) for x in timed["losses"]) or any(timed["k3"].values()):
            raise AssertionError(f"{name} timed steps: {timed}")
        if name == "conformer":
            timed = time_train_steps(dev, long_cfg, tag=f"{tag}[long]")
            k3 = timed["k3"]
            if k3 != {"k3_fwd": blocks, "k3_dq": blocks, "k3_dkv": blocks}:
                raise AssertionError(f"conformer train step at T = {win}: K3 launches {k3}")
            found["conformer_long"]["train_step"] = k3
    return found


ACCDOA_FAMILIES = (  # (model_type, overrides): full width, the JAX package's defaults
    ("accdoa_conformer", ["model.model_type=accdoa_conformer", "features.feature_set=mel_iv",
                          "targets.accdoa=true", "train.acs_augment=true"]),
    ("multi_accdoa_conformer", ["model.model_type=multi_accdoa_conformer",
                                "targets.accdoa=true", "targets.accdoa_tracks=3"]),
)
THRESHOLD_SWEEP = "0.3,0.4,0.5,0.6,0.7"
EDGE_DEG = 1e-3  # a decoded angle this close to a cell edge may round either way


def reset_launches() -> None:
    from seld_tpu_torch.ops.flash_attention import flash_attention as fa
    from seld_tpu_torch.ops.loss_cuda import grid_loss_terms
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames
    from seld_tpu_torch.ops.spatial_cuda import spatial_features

    log_mel_frames.launches = spatial_features.launches = 0
    grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0


def launches() -> dict:
    """K1, K2, K3 and K4's launches since reset_launches(), after a
    synchronize."""
    from seld_tpu_torch.ops.flash_attention import flash_attention as fa
    from seld_tpu_torch.ops.loss_cuda import grid_loss_terms
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames
    from seld_tpu_torch.ops.spatial_cuda import spatial_features

    torch.cuda.synchronize()
    return {"k1": log_mel_frames.launches, "k2_fwd": grid_loss_terms.fwd_launches,
            "k2_bwd": grid_loss_terms.bwd_launches, "k3_fwd": fa.fwd_launches,
            "k3_dq": fa.bwd_dq_launches, "k3_dkv": fa.bwd_dkv_launches,
            "k4": spatial_features.launches}


def only(**counts) -> dict:
    """The launches() dict of a path that launches these kernels and no other."""
    return {**dict.fromkeys(("k1", "k2_fwd", "k2_bwd", "k3_fwd", "k3_dq", "k3_dkv", "k4"), 0),
            **counts}


# a line of the port's log format, which the CLI writes to standard output
LOG_LINE = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d - seld_tpu_torch")


def printed_json(text: str):
    """The JSON document a CLI command printed among its log lines."""
    return json.loads("\n".join(x for x in text.splitlines() if not LOG_LINE.match(x)))


def cli_json(argv: list[str]) -> dict:
    """Run a CLI command that prints JSON; its parsed output."""
    from seld_tpu_torch import cli

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]}: rc {rc}")
    return printed_json(printed.getvalue())


def near_cell_edge(vectors: np.ndarray, n_el: int, n_az: int, threshold: float) -> np.ndarray:
    """(..., 3) vectors -> (...) bool: the float64 azimuth or elevation lies
    within EDGE_DEG of a cell edge, or the norm within 1e-6 of the threshold,
    where a float32 ulp of atan2 / asin on one device or the other can move
    the decode."""
    v = vectors.astype(np.float64)
    norm = np.linalg.norm(v, axis=-1)
    az = np.degrees(np.arctan2(v[..., 1], v[..., 0]))
    el = np.degrees(np.arcsin(np.clip(v[..., 2] / np.maximum(norm, 1e-9), -1, 1)))
    ja, je = (az + 180.0) / 360.0 * n_az, (el + 90.0) / 180.0 * n_el
    return ((np.abs(ja - np.round(ja)) * 360.0 / n_az < EDGE_DEG)
            | (np.abs(je - np.round(je)) * 180.0 / n_el < EDGE_DEG)
            | (np.abs(norm - threshold) < 1e-6))


def check_device_decode(pred, wave, tag: str) -> dict:
    """The model's vectors for the clip decoded on the card against the
    host decode of the same vectors (single-ACCDOA: the numpy decode;
    multi-ACCDOA: the numpy vote decode of the class-activity map made on
    the CPU): equal, but for frames with a vector at a cell edge; two
    device runs bit-equal; the served class grid equal to the device
    decode."""
    from seld_tpu_torch.accdoa import (
        decode_accdoa_to_grid,
        decode_accdoa_to_grid_np,
        decode_multi_accdoa_to_grid,
        decode_vote_grid_np,
        multi_accdoa_class_activity,
    )
    from seld_tpu_torch.data.corpus import compute_mel_features

    grid, th = pred.cfg.grid, pred.accdoa_threshold
    mel = compute_mel_features(wave, pred.cfg.features, pred.device)
    t_total, win = mel.shape[0], pred.win
    n = -(-t_total // win)
    mel = torch.cat([mel, mel.new_zeros((n * win - t_total, *mel.shape[1:]))])
    vectors = torch.cat(list(pred._batched(mel.reshape(n, win, *mel.shape[1:]),
                                           pred._raw_apply)))
    multi = pred.kind == "multi_accdoa"
    decode = decode_multi_accdoa_to_grid if multi else decode_accdoa_to_grid
    args = (grid.n_el, grid.n_az, grid.num_classes, th)
    on_card = decode(vectors, *args)
    if not torch.equal(on_card, decode(vectors, *args)):
        raise AssertionError(f"{tag} device decode: two runs differ")
    v = vectors.cpu()
    if multi:
        host = decode_vote_grid_np(
            multi_accdoa_class_activity(v, grid.n_el, grid.n_az, th).numpy(), grid.num_classes)
    else:
        host = decode_accdoa_to_grid_np(v.numpy(), *args)
    got = on_card.cpu().numpy().reshape(n * win, -1)
    differ = (got != host.reshape(n * win, -1)).any(axis=1)
    edge = near_cell_edge(v.numpy(), grid.n_el, grid.n_az, th).reshape(n * win, -1).any(axis=1)
    if (differ & ~edge).any():
        raise AssertionError(f"{tag} device decode differs from the host decode in "
                             f"{int((differ & ~edge).sum())} frames with no vector at a cell edge")
    served = pred.predict_waveform(wave).classes
    if not np.array_equal(served, got[:t_total]):
        raise AssertionError(f"{tag} served classes differ from the device decode")
    active = int((got != grid.num_classes - 1).sum())
    print(f"{tag} device decode at threshold {th:g} of {tuple(vectors.shape)} vectors: "
          f"{active} active cells; equal to the host decode in {n * win - int(differ.sum())} "
          f"of {n * win} frames ({int(differ.sum())} differ, each with a vector within "
          f"{EDGE_DEG:g} deg of a cell edge); two runs bit-equal; the served grid equal")
    return {"active_cells": active, "frames_differing": int(differ.sum())}


def phase_accdoa(dev: torch.device, flagship_run: Path) -> dict:
    """The ACCDOA families at full width (d_model 256, 4 heads, 2 blocks,
    CNN 64-512, 13 classes, bf16) on synthetic WAV files in the STARSS22
    layout: for accdoa_conformer on mel_iv with ACS (K4) and
    multi_accdoa_conformer on mel (K1), `cli train` (1 epoch), `cli eval
    --accdoa-threshold-sweep`, `cli calibrate`, `cli predict --calibration`
    of a 60 s clip, `cli score` of its CSV against its ground truth, every
    step's launches exact (K2 never); the device decode against the host
    decode; timed and profiled predicts and train steps; multi-ACCDOA at
    20 s windows (K3 once per block and forward). Then `cli calibrate` and
    `cli predict --calibration` of phase 6's flagship run (K2's forward once
    per eval step). Returns every path's launches."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.calibrate import DEFAULT_BIAS_GRID
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.data.audio import load_wav
    from seld_tpu_torch.data.synthetic import synthetic_raw_files
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    base = Config()
    fps = base.features.sample_rate // base.features.hop_length
    hop = base.window.hop_frames(base.features)
    train_steps = -(-(2 * 30 * fps // hop) // base.train.batch_size)
    eval_steps = -(-(20 * fps // hop) // base.train.batch_size)
    found = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        write_starss_layout(root, base, train_files=2, train_seconds=30.0, test_seconds=20.0)
        (clip_wav,), (clip_csv,) = synthetic_raw_files(root / "clip", base, n_files=1,
                                                       seconds=float(CLIP_SECONDS), seed=2)
        gt = root / "gt"
        gt.mkdir()
        shutil.copy(clip_csv, gt)
        wave, _ = load_wav(clip_wav)

        def predict_and_score(name, checkpoint, calib_path):
            out = root / f"out_{name}"
            reset_launches()
            if cli.main(["predict", "--checkpoint", str(checkpoint), "--calibration",
                         str(calib_path), "--wavs", clip_wav, "--out", str(out)]) != 0:
                raise AssertionError(f"cli predict {name} failed")
            counts = launches()
            scored = cli_json(["score", "--pred-dir", str(out / "predictions"),
                               "--gt-dir", str(gt)])
            if scored["n_files"] != 1 or not math.isfinite(scored["SELD_error"]):
                raise AssertionError(f"cli score {name}: {scored}")
            print(f"[{name}] cli predict --calibration of the {CLIP_SECONDS} s clip: launches "
                  f"{counts}; cli score against its ground truth: ER {scored['ER']:.3f} F "
                  f"{scored['F_macro']:.3f} LE {scored['LE_macro']:.1f} deg LR "
                  f"{scored['LR_macro']:.3f} SELD_error {scored['SELD_error']:.4f}")
            return counts

        for name, overrides in ACCDOA_FAMILIES:
            tag = f"[{name}]"
            cfg = parse_overrides(base, overrides)
            feature = "k4" if cfg.features.feature_set == "mel_iv" else "k1"
            args = [f"data.base_path={root}", f"data.checkpoint_dirname=ckpt_{name}", *overrides]
            work = root / f"ckpt_{name}"
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if cli.main(["train", *args, "train.num_epochs=1",
                         "train.save_every_n_epochs=1"]) != 0:
                raise AssertionError(f"cli train {name} failed")
            wall_s = time.perf_counter() - t0
            trained = launches()
            if trained != only(**{feature: 3}):
                raise AssertionError(f"{name} cli train launches {trained}")
            (record,) = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
            if not all(math.isfinite(record[s][k]) for s in ("train", "test")
                       for k in record[s]):
                raise AssertionError(f"{name} metrics.jsonl: {record}")
            print(f"{tag} cli train {' '.join(overrides)}: 1 epoch of {train_steps} train + "
                  f"{eval_steps} eval steps in {wall_s:.1f} s from 3 WAV files: launches "
                  f"{trained}; losses {record['train']}, test {record['test']}; peak device "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

            reset_launches()
            report = cli_json(["eval", *args, "--accdoa-threshold-sweep", THRESHOLD_SWEEP,
                               "--num-visualizations", "0"])
            evaluated = launches()
            sweep = report["accdoa_threshold_sweep"]
            if (evaluated != only(**{feature: 3}) or len(sweep["metrics"]) != 5
                    or abs(report["test_loss"] - record["test"]["loss"]) > 1e-4):
                raise AssertionError(f"{name} cli eval: launches {evaluated}, sweep {sweep}, "
                                     f"test loss {report['test_loss']}")
            print(f"{tag} cli eval --accdoa-threshold-sweep {THRESHOLD_SWEEP}: launches "
                  f"{evaluated}; test loss {report['test_loss']:.6f} (the trainer's "
                  f"{record['test']['loss']:.6f}); SELD_error by threshold "
                  f"{ {k: round(v['SELD_error'], 4) for k, v in sweep['metrics'].items()} }, "
                  f"best {sweep['best']['accdoa_threshold']}")

            reset_launches()
            calib = cli_json(["calibrate", *args, "--accdoa-threshold-sweep", THRESHOLD_SWEEP])
            calibrated = launches()
            if (calibrated != only(**{feature: 3}) or calib["model_type"] != name
                    or calib["accdoa_threshold"] not in map(float, THRESHOLD_SWEEP.split(","))):
                raise AssertionError(f"{name} cli calibrate: launches {calibrated}, {calib}")
            print(f"{tag} cli calibrate: launches {calibrated}; accdoa_threshold "
                  f"{calib['accdoa_threshold']}, median_filter {calib['median_filter']}, val "
                  f"SELD_error {calib['val_metrics']['SELD_error']:.4f}")
            best = sorted((work / "best").glob("epoch_*.pt"))[0]
            served_cli = predict_and_score(name, best, work / "decode_calibration.json")
            if served_cli != only(**{feature: 1}):
                raise AssertionError(f"{name} cli predict: launches {served_cli}")

            pred = SELDPredictor(best, batch_windows=8, device=dev,
                                 accdoa_threshold=calib["accdoa_threshold"])
            decoded = check_device_decode(pred, wave, tag)
            served = serve_clip(pred, wave, tag, profile=True)
            if served != {k: v for k, v in only(**{feature: 1}).items() if k in served}:
                raise AssertionError(f"{name} serving: launches {served}")
            del pred
            timed = time_train_steps(dev, cfg, tag=tag)
            if (not all(math.isfinite(x) for x in timed["losses"]) or any(timed["k3"].values())
                    or any(timed["k2"].values())):
                raise AssertionError(f"{name} timed steps: {timed}")
            found[name] = {"cli train": trained, "cli eval": evaluated,
                           "cli calibrate": calibrated, "cli predict": served_cli,
                           "decode": decoded, "train step": {**timed["k3"], **timed["k2"]}}

            if name == "multi_accdoa_conformer":  # 20 s windows: attention through K3
                long_cfg = cfg.replace_path("window.window_seconds", LONG_WINDOW_SECONDS)
                _, state, _ = load_checkpoint(best)
                save_checkpoint(root / "long.pt", state, long_cfg)
                pred = SELDPredictor(root / "long.pt", batch_windows=8, device=dev)
                served = serve_clip(pred, wave, f"{tag}[long]", profile=True)
                win = long_cfg.window.window_frames(long_cfg.features)
                forwards = -(-(-(-(1 + CLIP_SECONDS * fps) // win)) // 8)
                blocks = long_cfg.model.conf_n_layers
                if served != {"k1": 1, "k4": 0, "k3_fwd": forwards * blocks, "k3_dq": 0,
                              "k3_dkv": 0}:
                    raise AssertionError(f"{name} serving at T = {win}: launches {served}")
                del pred
                timed = time_train_steps(dev, long_cfg, tag=f"{tag}[long]")
                step = {**timed["k3"], **timed["k2"]}
                if step != {"k3_fwd": blocks, "k3_dq": blocks, "k3_dkv": blocks, "k2_fwd": 0,
                            "k2_bwd": 0} or not all(math.isfinite(x) for x in timed["losses"]):
                    raise AssertionError(f"{name} train step at T = {win}: {step}, "
                                         f"losses {timed['losses']}")
                found[f"{name} T = {win}"] = {"predict": served, "train step": step}

        # the grid path of calibration: phase 6's flagship run
        reset_launches()
        calib = cli_json(["calibrate", "--synthetic", f"data.base_path={flagship_run}"])
        calibrated = launches()
        if (calibrated != only(k1=3, k2_fwd=2 * eval_steps) or calib["bg_bias"] not in
                DEFAULT_BIAS_GRID or calib["model_type"] != "resnet_conformer"):
            raise AssertionError(f"flagship cli calibrate: launches {calibrated}, {calib}")
        print(f"[calibrate] cli calibrate of the flagship run: launches {calibrated} (two "
              f"passes of {eval_steps} eval steps); bg_bias {calib['bg_bias']}, median_filter "
              f"{calib['median_filter']}, val SELD_error "
              f"{calib['val_metrics']['SELD_error']:.4f}")
        best = sorted((flagship_run / "checkpoints" / "best").glob("epoch_*.pt"))[0]
        served_cli = predict_and_score("resnet_conformer", best,
                                       flagship_run / "checkpoints" / "decode_calibration.json")
        if served_cli != only(k1=1):
            raise AssertionError(f"flagship cli predict --calibration: launches {served_cli}")
        found["resnet_conformer"] = {"cli calibrate": calibrated, "cli predict": served_cli}
    return found


def accdoa_launches(found: dict, key: str) -> dict:
    """One kernel's launches on every counted path of phase 14."""
    return {f"{model} {path}": counts[key] for model, paths in found.items()
            for path, counts in paths.items() if key in counts}


FLAGSHIP_OPTIONS = (("as it is", []), ("norm_dtype=bfloat16", ["model.norm_dtype=bfloat16"]),
                    ("remat=all", ["model.remat=all"]),
                    ("both", ["model.norm_dtype=bfloat16", "model.remat=all"]))


def phase_flagship_options(dev: torch.device) -> dict:
    """The flagship's train step at T = 1000 four ways: as it is, with bf16
    norms, with remat=all, with both: step ms, kernel time by family (the
    profile lines), peak device memory, and K3's launches in one step
    (remat recomputes every conformer block, so K3's forward launches
    twice per block). Returns K3's counts of each."""
    from seld_tpu_torch.config import Config, parse_overrides

    found = {}
    for name, overrides in FLAGSHIP_OPTIONS:
        cfg = parse_overrides(Config(), [f"window.window_seconds={LONG_WINDOW_SECONDS}",
                                         *overrides])
        blocks = cfg.model.resnet_conf_n_layers
        timed = time_train_steps(dev, cfg, tag=f"[options {name}]")
        recompute = 2 if cfg.model.remat in ("conformer", "all") else 1
        want = {"k3_fwd": recompute * blocks, "k3_dq": blocks, "k3_dkv": blocks}
        if timed["k3"] != want or not all(math.isfinite(x) for x in timed["losses"]):
            raise AssertionError(f"flagship {name} at T = 1000: K3 {timed['k3']}, expected "
                                 f"{want}; losses {timed['losses']}")
        print(f"[options] flagship {name}: step {timed['step_ms']:.2f} ms, peak device memory "
              f"{timed['peak_gib']:.2f} GiB, K3 forward {timed['k3']['k3_fwd']} launches a "
              f"step")
        found[name] = timed["k3"]
    return found


# K1's and K4's kernels at other n_fft: the mixed-radix kernels timed at
# 1200 (50 ms at 24 kHz) and 600, checked at 640, 882, 1764 and 1920 (40
# ms at 16 kHz, 20 ms and 40 ms at 44.1 kHz, 40 ms at 48 kHz); the DFT
# tiles at 1202 = 2 x 601
MIXED_TIMED_N_FFT = (1200, 600)
MIXED_CHECKED_N_FFT = (640, 882, 1764, 1920)
DFT_N_FFT = 1202
# K5 against K3 over the whole T: the JAX ring tests' bars in float32
# (tests/test_pallas_kernels.py:421-465); bf16 by check_bf16, as K3
K5_TOL = dict(rtol=2e-4, atol=2e-5)
K5_GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
SP_LOSS_RTOL = 1e-5  # sharded against unsharded first-step loss on one card
# an epoch's mean loss after Adam steps whose gradients carry cuDNN's
# nondeterministic sums (each run of the backward rounds differently)
SP_EPOCH_RTOL = 1e-3


def k1_counts() -> tuple[int, int, int]:
    """K1's launches by kernel: register FFT, mixed-radix, DFT tiles."""
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames as k1

    return k1.launches, k1.mixed_launches, k1.dft_launches


def k4_counts() -> tuple[int, int, int]:
    """K4's launches by kernel: register FFT, mixed-radix, DFT tiles."""
    from seld_tpu_torch.ops.spatial_cuda import spatial_features as k4

    return k4.launches, k4.mixed_launches, k4.dft_launches


def moved(before: tuple, after: tuple) -> tuple:
    return tuple(a - b for a, b in zip(after, before))


def phase_f2(dev: torch.device) -> list[dict]:
    """K1's and K4's kernels at n_fft outside 512 / 960 / 1024 / 2048.
    The mixed-radix kernels at n_fft 1200 and 600 against their plain
    versions, contiguous and on frame_signal's in-place view of a padded
    60 s clip, timed in turns against the plain version, the library chain
    and the DFT tiles at the same n_fft (through their C entry: `launch`);
    at 640, 882, 1764 and 1920 checked alone; the DFT tiles at 1202 checked
    and timed; the register kernels re-timed at their four n_fft in the
    same call. Then the path that runs them: a seeded flagship at n_fft
    1200, 600 and 1202 serving the 60 s clip for "mel", "mel_iv" and
    "mel_gcc", each launch count exact (the mixed-radix kernel once at
    1200 and 600, the DFT tiles once at 1202, nothing else)."""
    import torch.nn.functional as F

    from seld_tpu_torch.config import Config, FeatureConfig, parse_overrides
    from seld_tpu_torch.features import spatial as oracle
    from seld_tpu_torch.features.mel import frame_signal, hann_window, mel_filterbank
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops import mel_cuda, spatial_cuda
    from seld_tpu_torch.ops.mel_cuda import KERNEL_N_FFT, log_mel_frames, log_mel_frames_reference
    from seld_tpu_torch.ops.spatial_cuda import spatial_features, spatial_features_reference
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    feat = FeatureConfig()
    n_mels, hop, sr = feat.n_mels, feat.hop_length, feat.sample_rate
    t_main = 1 + CLIP_SECONDS * sr // hop
    n = 4 * t_main
    g = torch.Generator(device=dev).manual_seed(11)
    wave = 0.1 * torch.randn((4, CLIP_SECONDS * sr), generator=g, device=dev)
    k1_path = {1: "register FFT", 2: "mixed-radix", 3: "DFT tiles"}

    def check(nf: int, path: int) -> tuple[float, float, float]:
        """K1 (contiguous and in place) and K4 (every set, in place and on the
        contiguous copy) at nf, each launch on kernel `path` (1-based in the
        counts); their largest errors: K1 dB, K4 dB, K4 other planes."""
        frames = torch.randn((n, nf), generator=g, device=dev)
        view = frame_signal(wave, nf, hop)
        copy = view.contiguous()
        want = tuple(2 if i == path - 1 else 0 for i in range(3))
        before = k1_counts()
        got, got_v = log_mel_frames(frames, n_fft=nf), log_mel_frames(view, n_fft=nf)
        torch.cuda.synchronize()
        if moved(before, k1_counts()) != want:
            raise AssertionError(f"K1 at n_fft={nf}: launches {moved(before, k1_counts())}, "
                                 f"expected {want}")
        e1 = max(k1_check(f"{k1_path[path]} n_fft={nf}", got, log_mel_frames_reference(frames)),
                 k1_check(f"{k1_path[path]} n_fft={nf} in place", got_v,
                          log_mel_frames_reference(copy.reshape(-1, nf)).reshape(got_v.shape)))
        e4 = [0.0, 0.0]
        for fs in ("mel", "mel_iv", "mel_gcc"):
            before = k4_counts()
            out_v, out_c = spatial_features(view, fs), spatial_features(copy, fs)
            torch.cuda.synchronize()
            if moved(before, k4_counts()) != want:
                raise AssertionError(f"K4 {fs} at n_fft={nf}: launches "
                                     f"{moved(before, k4_counts())}, expected {want}")
            ref = spatial_features_reference(copy, fs)
            for what, out in (("in place", out_v), ("contiguous", out_c)):
                errs = k4_errors(out, ref)
                k4_check(f"{k1_path[path]} n_fft={nf} {fs} {what}", errs)
                e4 = [max(e4[0], errs[0]), max(e4[1], errs[1])]
        print(f"[F2] {k1_path[path]} n_fft={nf}: K1 N={n} max |kernel - plain| {e1:.3e} dB "
              f"(contiguous and in place); K4 T={t_main} mel / mel_iv / mel_gcc, in place and "
              f"contiguous, {e4[0]:.3e} dB / {e4[1]:.3e}; launches {want[path - 1]} a check")
        return e1, *e4

    def timed(nf: int, path: str) -> list[dict]:
        """K1 and K4 (mel_iv, mel_gcc, in place) at nf on kernel `path`
        ("mixed" or "dft"), in turns with the plain version, the library
        chain and, for "mixed", the DFT tiles at the same nf; their rows."""
        name = "mixed-radix" if path == "mixed" else "DFT path"
        frames = torch.randn((n, nf), generator=g, device=dev)
        padded = F.pad(wave, (nf // 2, nf // 2), mode="reflect")
        view = frame_signal(wave, nf, hop)
        copy = view.contiguous()
        window = torch.from_numpy(hann_window(nf)).to(dev)
        fb = torch.from_numpy(mel_filterbank(nf // 2 + 1, n_mels, sr)).to(dev)
        err = max(k1_check(f"{name} n_fft={nf}", mel_cuda.launch(path, frames, nf),
                           log_mel_frames_reference(frames)),
                  k1_check(f"{name} n_fft={nf} in place", mel_cuda.launch(path, view, nf),
                           log_mel_frames_reference(copy.reshape(-1, nf)).reshape(
                               4, t_main, n_mels)))
        runs = {"kernel": lambda: mel_cuda.launch(path, frames, nf),
                "plain": lambda: log_mel_frames_reference(frames),
                "stft chain": lambda: library_log_mel(frames, window, fb),
                "kernel in place": lambda: mel_cuda.launch(path, view, nf)}
        if path == "mixed":
            runs["DFT tiles"] = lambda: mel_cuda.launch("dft", frames, nf)
        ms = timed_in_turns(runs)
        b = k1_bound(n, nf, fb)
        print(f"[F2] K1 {name} n_fft={nf}, N={n}: max |kernel - plain| {err:.3e} dB; kernel "
              f"{ms['kernel']:.4f} ms, in place {ms['kernel in place']:.4f} ms, plain "
              f"{ms['plain']:.4f} ms, stft chain {ms['stft chain']:.4f} ms"
              + (f", DFT tiles {ms['DFT tiles']:.4f} ms" if path == "mixed" else "")
              + f"; bound {b['bound_ms']:.4f} ms by {b['bound_by']}: kernel at "
              f"{100 * b['bound_ms'] / ms['kernel']:.2f} %, "
              f"{ms['stft chain'] / ms['kernel']:.2f}x the stft chain's speed")
        rows = [{"name": f"K1 {name} n_fft={nf}", "route": "cuda",
                 "source": "seld_tpu_torch/csrc/mel_kernel.cu",
                 "replaces": "seld_tpu/ops/mel_pallas.py:77", "launches": None,
                 "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
                 "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                 "library_ms": ms["stft chain"], "in_place_ms": ms["kernel in place"],
                 **({"dft_tiles_ms": ms["DFT tiles"]} if path == "mixed" else {})}]
        for fs in ("mel_iv", "mel_gcc"):
            errs = k4_errors(spatial_cuda.launch(path, view, fs),
                             spatial_features_reference(copy, fs))
            k4_check(f"{name} n_fft={nf} {fs}", errs)
            runs = {"kernel": lambda: spatial_cuda.launch(path, view, fs),
                    "plain": lambda: spatial_features_reference(copy, fs),
                    "rFFT chain": lambda: oracle.extract_feature_frames(copy, fs, nf, n_mels, sr)}
            if path == "mixed":
                runs["DFT tiles"] = lambda: spatial_cuda.launch("dft", view, fs)
            ms = timed_in_turns(runs)
            b = k4_bound(t_main, nf, fb, fs, input_bytes=padded.numel() * 4)
            print(f"[F2] K4 {name} {fs} n_fft={nf}, T={t_main} in place: max |kernel - plain| "
                  f"{errs[0]:.3e} dB / {errs[1]:.3e}; kernel {ms['kernel']:.4f} ms, plain "
                  f"{ms['plain']:.4f} ms, rFFT chain {ms['rFFT chain']:.4f} ms"
                  + (f", DFT tiles {ms['DFT tiles']:.4f} ms" if path == "mixed" else "")
                  + f"; bound {b['bound_ms']:.4f} ms by {b['bound_by']}: kernel at "
                  f"{100 * b['bound_ms'] / ms['kernel']:.2f} %, "
                  f"{ms['rFFT chain'] / ms['kernel']:.2f}x the rFFT chain's speed")
            rows.append({"name": f"K4 {fs} {name} n_fft={nf}", "route": "cuda",
                         "source": "seld_tpu_torch/csrc/spatial_kernel.cu",
                         "replaces": "seld_tpu/ops/spatial_pallas.py:132", "launches": None,
                         "max_abs_err": max(errs), "ms": ms["kernel"],
                         "plain_ms": ms["plain"], "bound_ms": b["bound_ms"],
                         "bound_by": b["bound_by"], "library_ms": ms["rFFT chain"],
                         **({"dft_tiles_ms": ms["DFT tiles"]} if path == "mixed" else {})})
        return rows

    rows = []
    for nf in MIXED_TIMED_N_FFT:
        check(nf, 2)
        rows += timed(nf, "mixed")
    for nf in MIXED_CHECKED_N_FFT:
        check(nf, 2)
    check(DFT_N_FFT, 3)
    rows += timed(DFT_N_FFT, "dft")
    for nf in KERNEL_N_FFT:  # the register kernels, re-timed beside the new ones
        frames = torch.randn((n, nf), generator=g, device=dev)
        view = frame_signal(wave, nf, hop)
        ms = timed_in_turns({"K1": lambda: log_mel_frames(frames, n_fft=nf),
                             "K1 in place": lambda: log_mel_frames(view, n_fft=nf),
                             **{f"K4 {fs} in place": (lambda fs=fs: spatial_features(view, fs))
                                for fs in ("mel_iv", "mel_gcc")}})
        print(f"[F2] register FFT n_fft={nf}: " + ", ".join(f"{k} {v:.4f} ms"
                                                          for k, v in ms.items()))
    del frames, view

    # the path: a flagship at each n_fft serving the clip
    clip = (0.1 * np.random.default_rng(0).standard_normal((4, CLIP_SECONDS * sr))
            ).astype(np.float32)
    (ROOT / "build").mkdir(exist_ok=True)
    served = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for nf, feature_set in itertools.product((*MIXED_TIMED_N_FFT, DFT_N_FFT),
                                                 ("mel", "mel_iv", "mel_gcc")):
            cfg = parse_overrides(Config(), [f"features.n_fft={nf}",
                                             f"features.feature_set={feature_set}"])
            model = build_model(cfg.model, cfg.grid, device=dev, seed=0, in_channels=(
                feature_channels(feature_set, cfg.model.n_channels)))
            save_checkpoint(Path(tmp) / f"{feature_set}.pt", model, cfg)
            del model
            pred = SELDPredictor(Path(tmp) / f"{feature_set}.pt", batch_windows=8, device=dev)
            pred.predict_waveform(clip)  # warm-up
            torch.cuda.synchronize()
            for counter in (log_mel_frames, spatial_features):
                counter.launches = counter.mixed_launches = counter.dft_launches = 0
            classes = pred.predict_waveform(clip).classes
            torch.cuda.synchronize()
            counts = k1_counts() + k4_counts()
            slot = (1 if nf != DFT_N_FFT else 2) + (0 if feature_set == "mel" else 3)
            want = tuple(int(i == slot) for i in range(6))
            if counts != want or classes.shape != (t_main, cfg.grid.n_cells):
                raise AssertionError(f"n_fft={nf} {feature_set} predict: launches (K1 FFT, "
                                     f"mixed, DFT; K4 FFT, mixed, DFT) {counts}, expected "
                                     f"{want}; classes {classes.shape}")
            served[nf, feature_set] = counts[slot]
            print(f"[F2] SELDPredictor, features.n_fft={nf} {feature_set}: 60 s clip -> "
                  f"classes {tuple(classes.shape)}; launches K1 FFT / mixed / DFT "
                  f"{counts[0]} / {counts[1]} / {counts[2]}, K4 FFT / mixed / DFT "
                  f"{counts[3]} / {counts[4]} / {counts[5]}")
            del pred
    for row in rows:
        nf = int(row["name"].rsplit("=", 1)[1])
        row["launches"] = served[nf, "mel" if row["name"].startswith("K1")
                                 else row["name"].split()[1]]
    return rows


def timed_in_turns(runs: dict, turns: int = 3, host: dict | None = None) -> dict:
    """Median kernel_ms of each fn, in turns (forward, then reversed); with
    `host` (µs of host time a call, by name) each spin covers that time."""
    times = defaultdict(list)
    for turn in range(turns):
        for name, fn in (runs.items() if turn % 2 == 0 else reversed(runs.items())):
            times[name].append(kernel_ms(fn, (host or {}).get(name, 0.0)))
    return {name: float(np.median(v)) for name, v in times.items()}


def k5_bounds(bh: int, t: int, dh: int, dtype: torch.dtype) -> dict:
    """The least card time for the ring's function on (bh, t, dh) inputs:
    exact attention at the whole T, whatever the number of ranks, so K3's
    bound at the whole T (its operations at the tensor cores' peak against
    q, k, v, out, lse (and dO, delta, dq, dk, dv) each moved once; the
    larger of the two). The running state's bytes belong to a design with a
    launch per step, not to the function."""
    k3 = k3_bounds(bh, t, dh, dtype)
    return {part: k3[part] for part in ("fwd", "bwd")}


def close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max |got - want| - rtol |want| over atol: at most 1 when within the bar."""
    return ((got.float() - want.float()).abs() - rtol * want.float().abs()).max().item() / atol


def ring_run(qs, ks, vs, ws, plain: bool = True):
    """(out, lse (B, H, T), dq, dk, dv) over the whole T of the virtual ring
    over the chunks (the plain steps by default)."""
    from seld_tpu_torch.ops.ring_attention import virtual_ring_attention, virtual_ring_backward

    b, h = qs[0].shape[:2]
    outs, lses = virtual_ring_attention(qs, ks, vs, plain=plain)
    grads = virtual_ring_backward(qs, ks, vs, ws, outs, lses, plain=plain)
    return (torch.cat(outs, 2), torch.cat([x.view(b, h, -1) for x in lses], 2),
            *(torch.cat(g, 2) for g in grads))


def profiled_kernels(fn) -> list[tuple[str, float]]:
    """The CUDA kernels of one fn() call on the profiler, in start order:
    (name, device µs). fn's launches queue behind a 5 ms spin (left out):
    a profiler session after earlier ones can lose the first device events
    it sees."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(5e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3))
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation and "spin_kernel" not in e.name),
                    key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in events]


def ring_steps_us(n: int, kernels: list[tuple[str, float]], kind: str) -> str:
    """The mean device µs of a lane's K3 launch in each step of a profiled
    ring call (`kind` of "flash_fwd_", "flash_dq_", "flash_dkv_")."""
    us = [t for name, t in kernels if kind in name]
    return " / ".join(f"{sum(us[i * n:(i + 1) * n]) / n:.1f}" for i in range(len(us) // n))


def check_ring_kernels(n: int, fwd: list[str], bwd: list[str], kind: str) -> int:
    """A ring call at n ranks is one K3-family launch a lane and step forward
    and two backward: the forward n x n forward kernels and nothing else;
    the backward n dQ then n dK/dV launches a step, and after the last of
    them at most the 2 n casts of dk and dv at home. In bf16 no other kernel
    comes before the last K3 launch; in float32 only row_delta's multiply
    and sum per lane (the first step's delta, as K3's own float32
    backward forms it). Returns the count of kernels that are not K3's."""
    fam = "wgmma" if kind == "bf16" else "f32"
    if len(fwd) != n * n or not all(f"flash_fwd_{fam}_kernel" in x for x in fwd):
        raise AssertionError(f"K5 {kind} forward at n={n}: kernels {fwd}")
    flash = [i for i, x in enumerate(bwd) if "flash_" in x]
    kinds = ["dq" if f"flash_dq_{fam}_kernel" in bwd[i] else
             "dkv" if f"flash_dkv_{fam}_kernel" in bwd[i] else "?" for i in flash]
    before = flash[-1] + 1 - len(flash) if flash else 0
    if (kinds != (["dq"] * n + ["dkv"] * n) * n or before > (0 if kind == "bf16" else 2 * n)
            or len(bwd) - 1 - (flash[-1] if flash else 0) > 2 * n):
        raise AssertionError(f"K5 {kind} backward at n={n}: kernels {bwd}")
    return len(bwd) - 2 * n * n


def phase_k5_profile(dev: torch.device) -> dict:
    """K5 at n = 4 virtual ranks, K3's main-path shape, float32 and bf16,
    on the profiler: check_ring_kernels, and the device µs of a lane's
    launch in each step. Run before any other phase profiles: a profiler
    session after earlier ones can lose device events. Returns the kernel
    ms of a bf16 call, forward and backward."""
    from seld_tpu_torch.config import Config, WindowConfig
    from seld_tpu_torch.ops.ring_attention import virtual_ring_attention, virtual_ring_backward

    cfg = Config(window=WindowConfig(window_seconds=LONG_WINDOW_SECONDS))
    b, h = cfg.train.batch_size, cfg.model.resnet_conf_n_heads
    t, dh = cfg.window.window_frames(cfg.features), cfg.model.resnet_conf_d_model // h
    n, found = 4, {}
    for dtype in (torch.float32, torch.bfloat16):
        kind = "bf16" if dtype == torch.bfloat16 else "float32"
        qs, ks, vs, ws = (list(x.chunk(n, dim=2)) for x in k3_case(dev, b, h, t, dh, dtype, 21))
        with torch.no_grad():
            outs, lses = virtual_ring_attention(qs, ks, vs)
            virtual_ring_backward(qs, ks, vs, ws, outs, lses)
            profiled = (profiled_kernels(lambda: virtual_ring_attention(qs, ks, vs)),
                        profiled_kernels(lambda: virtual_ring_backward(qs, ks, vs, ws, outs,
                                                                       lses)))
        names = [[name for name, _ in x] for x in profiled]
        others = check_ring_kernels(n, *names, kind)
        found[kind] = [sum(us for _, us in x) / 1e3 for x in profiled]
        print(f"[K5] {kind} ring n={n} on the profiler: forward {len(names[0])} kernels, all "
              f"K3's forward; backward {len(names[1])}: {2 * n * n} dQ / dK/dV, n of each in "
              f"turn, nothing between them, and {others} others "
              f"({sorted(set(x[:90] for x in names[1] if 'flash_' not in x))})")
        print(f"[K5] {kind} ring n={n}, device us of a lane's launch by step (the first writes "
              f"the running state, the later ones read it too, the last stores the result): "
              f"forward {ring_steps_us(n, profiled[0], 'flash_fwd_')}; dQ "
              f"{ring_steps_us(n, profiled[1], 'flash_dq_')}; dK/dV "
              f"{ring_steps_us(n, profiled[1], 'flash_dkv_')}; the others "
              f"{sum(us for name, us in profiled[1] if 'flash_' not in name):.1f} in all; "
              f"kernel time a call {found[kind][0]:.4f} ms forward, {found[kind][1]:.4f} ms "
              f"backward")
        del qs, ks, vs, ws, outs, lses
    return {"fwd": found["bf16"][0], "bwd": found["bf16"][1]}


PARENT_TREE = ROOT / "build" / "ab" / "parent"  # an unpacked `git archive` of the parent commit


def parent_ring() -> dict | None:
    """K5 of the tree at PARENT_TREE and of this one timed in turns (parent,
    this, this, parent) by scripts/ring_ab.py, each in a process of its own;
    None when there is no parent tree (it is made beside a run, not kept)."""
    if not (PARENT_TREE / "seld_tpu_torch").is_dir():
        print(f"[K5] no parent tree at {PARENT_TREE.relative_to(ROOT)} (unpack `git archive "
              f"<parent>` there to time the parent design in turns): not timed")
        return None
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / "ring_ab.py"), str(PARENT_TREE),
                          str(ROOT)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"scripts/ring_ab.py failed:\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-6000:]}")
    for line in res.stdout.splitlines()[:-1]:
        print(line)
    summary = json.loads(res.stdout.splitlines()[-1])["ring_ab"]
    for key, values in summary.items():
        print(f"[K5 A/B] {key}: " + ", ".join(f"{m} {' / '.join(f'{x:.4f}' for x in v)}"
                                             for m, v in values.items()))
    return summary


def phase_k5(dev: torch.device) -> list[dict]:
    """K5, the ring, at K3's main-path shape (B 16, H 8, T = 1000, Dh 64) in
    float32 and bf16: the virtual ring (n ranks in this process, one K3
    kernel launch a lane and step forward with the merge in its epilogue,
    two backward with the sums in their stores) at n = 1 (K3's bits), 2 and
    4, in float32 against K3 over the whole T (out, lse, dq, dk, dv) and
    against the plain ring, in bf16 by check_bf16 against the float32 plain
    ring beside the bf16 plain ring; its launches (n x n of each, counted by
    K5 and by K3) and no copies (the profiled calls: phase_k5_profile); the
    host µs of a ring call; times of the ring's forward and backward at
    n = 4, of K3 over the whole T, the plain ring and
    scaled_dot_product_attention, in turns; the bound; and, where a parent
    tree is unpacked, the parent design's ring in turns (parent_ring)."""
    import torch.nn.functional as F

    from seld_tpu_torch.config import Config, WindowConfig
    from seld_tpu_torch.ops import flash_attention as k3
    from seld_tpu_torch.ops.ring_attention import (
        ring_flash_attention as k5,
        virtual_ring_attention,
        virtual_ring_backward,
    )

    def counts():
        fa = k3.flash_attention
        return (k5.fwd_launches, k5.bwd_dq_launches, k5.bwd_dkv_launches, fa.fwd_launches,
                fa.bwd_dq_launches, fa.bwd_dkv_launches, fa.copies)

    cfg = Config(window=WindowConfig(window_seconds=LONG_WINDOW_SECONDS))
    b, h = cfg.train.batch_size, cfg.model.resnet_conf_n_heads
    t, dh = cfg.window.window_frames(cfg.features), cfg.model.resnet_conf_d_model // h
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        kind = "bf16" if dtype == torch.bfloat16 else "float32"
        q, k, v, w = k3_case(dev, b, h, t, dh, dtype, seed=21)
        want = k3_run(lambda *a: k3.flash_attention(*a, return_lse=True), q, k, v, w)
        ref = (want[0], want[1].view(b, h, -1), *want[2:])
        worst = {}
        for n in (1, 2, 4):
            qs, ks, vs, ws = (list(x.chunk(n, dim=2)) for x in (q, k, v, w))
            before = counts()
            got = ring_run(qs, ks, vs, ws, plain=False)
            torch.cuda.synchronize()
            made = tuple(a - c for a, c in zip(counts(), before))
            if made != (n * n,) * 6 + (0,):
                raise AssertionError(f"K5 n={n}: launches (K5 fwd, dQ, dK/dV; K3 fwd, dQ, "
                                     f"dK/dV; K3 copies) {made}, expected {n * n} each "
                                     f"(n lanes x n steps) and no copy")
            for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
                worst[n, name] = (got[i].float() - ref[i].float()).abs().max().item()
            if n == 1:
                if max(worst[1, x] for x in ("out", "lse", "dq", "dk", "dv")) > 0.0:
                    raise AssertionError(f"K5 {kind} n=1 differs from K3: {worst}")
                print(f"[K5] {kind} virtual ring n=1, B*H={b * h} T={t} Dh={dh}: out, lse, dq, "
                      f"dk, dv bit-equal to K3; launches {made[:3]}")
                continue
            plain = ring_run(qs, ks, vs, ws)
            if dtype == torch.float32:
                for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
                    tol = K5_TOL if i < 2 else K5_GRAD_TOL
                    score = max(close(got[i], ref[i], **tol), close(got[i], plain[i], **tol))
                    if not score <= 1.0:
                        raise AssertionError(f"K5 {kind} n={n} {name} outside its bar "
                                             f"({score:.3f} of it)")
            print(f"[K5] {kind} virtual ring n={n}, B*H={b * h} T={t} Dh={dh}: max |ring - K3 "
                  f"over the whole T| out {worst[n, 'out']:.3e}, lse {worst[n, 'lse']:.3e}, dq "
                  f"{worst[n, 'dq']:.3e}, dk {worst[n, 'dk']:.3e}, dv {worst[n, 'dv']:.3e}; "
                  f"launches {made[:3]} (K5) = {made[3:6]} (K3), copies 0")
            if dtype == torch.bfloat16:
                exact = ring_run(*(list(x.float().chunk(n, dim=2)) for x in (q, k, v, w)))
                parts = check_bf16(f"K5 bf16 n={n}", got, plain, exact)
                print(f"[K5] bf16 virtual ring n={n}: max error against the float32 plain "
                      f"ring, ring / bf16 plain ring: {parts} (ring at most {K3_BF16_RATIO} x "
                      f"plain)")
                del exact
            del plain
        n = 4
        qs, ks, vs, ws = (list(x.chunk(n, dim=2)) for x in (q, k, v, w))
        with torch.no_grad():
            outs, lses = virtual_ring_attention(qs, ks, vs)
            p_outs, p_lses = virtual_ring_attention(qs, ks, vs, plain=True)
            scale = dh ** -0.5
            whole_out, whole_lse = k3.launch_forward(q, k, v, scale)

            def ring_fwd():
                return virtual_ring_attention(qs, ks, vs)

            def ring_bwd():
                return virtual_ring_backward(qs, ks, vs, ws, outs, lses)

            host = {"fwd": host_us(ring_fwd, calls=50), "bwd": host_us(ring_bwd, calls=50)}
            fwd = timed_in_turns({
                "ring": ring_fwd,
                "K3": lambda: k3.launch_forward(q, k, v, scale),
                "plain ring": lambda: virtual_ring_attention(qs, ks, vs, plain=True),
                "sdpa": lambda: F.scaled_dot_product_attention(q, k, v)},
                host={"ring": host["fwd"]})
            bwd = timed_in_turns({
                "ring": ring_bwd,
                "K3": lambda: k3.launch_dkv(q, k, v, w, whole_lse,
                                            k3.launch_dq(q, k, v, w, whole_out, whole_lse,
                                                         scale)[1], scale),
                "plain ring": lambda: virtual_ring_backward(qs, ks, vs, ws, p_outs, p_lses,
                                                            plain=True)},
                host={"ring": host["bwd"]})
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves)
        bwd["sdpa"] = kernel_ms(lambda: torch.autograd.grad(o, leaves, w, retain_graph=True))
        del o, leaves
        bounds = k5_bounds(b * h, t, dh, dtype)
        for part, ms in (("fwd", fwd), ("bwd", bwd)):
            bd = bounds[part]
            print(f"[K5] {kind} ring {part} n={n}: {ms['ring']:.4f} ms of device time, "
                  f"{host[part]:.1f} us of host time a call; K3 over the whole T {ms['K3']:.4f} "
                  f"ms ({ms['ring'] / ms['K3']:.2f}x), plain ring {ms['plain ring']:.4f} ms, "
                  f"scaled_dot_product_attention {part} {ms['sdpa']:.4f} ms "
                  f"({ms['ring'] / ms['sdpa']:.2f}x); bound {bd['bound_ms']:.4f} ms (K3's by "
                  f"{bd['bound_by']} at the whole T): ring at "
                  f"{100 * bd['bound_ms'] / ms['ring']:.2f} %")
            if dtype == torch.bfloat16:
                # launches: set by main from the sharded cli train epoch (n = 1)
                rows.append({
                    "name": f"K5 {part}", "route": "cuda",
                    "source": "seld_tpu_torch/csrc/flash_attention_kernel.cu",
                    "replaces": "seld_tpu/ops/ring_attention.py:53", "launches": None,
                    "timed": f"virtual ring, n = {n}, B*H={b * h} T={t} Dh={dh}",
                    "timed_call_launches": ({"K3 fwd": n * n} if part == "fwd" else
                                            {"K3 dQ": n * n, "K3 dK/dV": n * n}),
                    "max_abs_err": max(worst[n, x] for x in (("out", "lse") if part == "fwd"
                                                             else ("dq", "dk", "dv"))),
                    "ms": ms["ring"], "plain_ms": ms["plain ring"],
                    "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
                    "library_ms": ms["sdpa"], "host_us": host[part]})
        del q, k, v, w, outs, lses, p_outs, p_lses, whole_out, whole_lse
    torch.cuda.empty_cache()
    parent = parent_ring()
    if parent is not None:
        for row in rows:
            part = row["name"].split()[1]
            row["parent_ms"] = parent[f"parent bf16 {part}"]["ms"]
            row["parent_host_us"] = parent[f"parent bf16 {part}"]["host_us"]
    return rows


def sp_worker(argv: list[str]) -> int:
    """`chip_smoke.py --sp-worker ARGS` (one rank under torchrun): the CLI
    with ARGS, then this process's launch counts as one JSON line."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.ops.flash_attention import flash_attention as fa
    from seld_tpu_torch.ops.ring_attention import ring_flash_attention as k5

    rc = cli.main(argv)
    torch.cuda.synchronize()
    print("[sp-worker] " + json.dumps({
        "rc": rc, "k3_fwd": fa.fwd_launches, "k3_dq": fa.bwd_dq_launches,
        "k3_dkv": fa.bwd_dkv_launches, "k5_fwd": k5.fwd_launches,
        "k5_dq": k5.bwd_dq_launches, "k5_dkv": k5.bwd_dkv_launches}), flush=True)
    return rc


def phase_sequence_parallel(dev: torch.device, long_train_loss: float) -> dict:
    """The sequence-parallel path at full width, T = 1000, on a 1-rank NCCL
    group: the ring at n = 1 against K3 (values and gradients); the
    flagship's first train step sharded over the (1 x 1) mesh (K5) and as
    data parallel, against the unsharded step on the same batch (loss within
    SP_LOSS_RTOL), step times in turns; then `torchrun --nproc-per-node 1
    -m seld_tpu_torch.cli train` with mesh.enable=on, shard_time true and
    false, one epoch each, their launch counts (the ring's K3 launches
    exact) and epoch losses against phase 7's unsharded run. Returns the
    sharded CLI run's counts."""
    import torch.distributed as dist

    from seld_tpu_torch.config import Config, WindowConfig
    from seld_tpu_torch.data.sampler import BatchIterator, place_batch
    from seld_tpu_torch.data.synthetic import synthetic_corpus
    from seld_tpu_torch.losses import SELDLossFn
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.ops import flash_attention as k3
    from seld_tpu_torch.ops.ring_attention import ring_flash_attention as k5
    from seld_tpu_torch.parallel.mesh import make_mesh
    from seld_tpu_torch.parallel.multihost import initialize_multihost
    from seld_tpu_torch.train.optimizer import make_optimizer
    from seld_tpu_torch.train.state import create_train_state
    from seld_tpu_torch.train.steps import make_train_step

    cfg = Config(window=WindowConfig(window_seconds=LONG_WINDOW_SECONDS))
    blocks = cfg.model.resnet_conf_n_layers
    initialize_multihost(dev)
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"expected a 1-rank NCCL group, got {dist.get_backend()}")
        mesh = make_mesh(1, 1)
        # the ring at n = 1 over the NCCL group against K3 over the whole T
        q, k, v, w = k3_case(dev, cfg.train.batch_size, 8, 1000, 64, torch.bfloat16, seed=22)
        want = k3_run(lambda *a: k3.flash_attention(*a, return_lse=True), q, k, v, w)
        got = k3_run(lambda *a: k5(*a, group=mesh.model_group, return_lse=True), q, k, v, w)
        diffs = [(x.float() - y.float()).abs().max().item() for x, y in zip(got, want)]
        if max(diffs) > 0.0:
            raise AssertionError(f"the 1-rank NCCL ring differs from K3: {diffs}")
        plain = ring_run([q], [k], [v], [w])
        exact = ring_run(*([x.float()] for x in (q, k, v, w)))
        parts = check_bf16("the 1-rank NCCL ring", (got[0], got[1].view(plain[1].shape),
                                                    *got[2:]), plain, exact)
        print(f"[SP] ring over a 1-rank NCCL group, bf16 B*H=128 T=1000: out, lse, dq, dk, dv "
              f"bit-equal to K3 (max differences {diffs}); max error against the float32 "
              f"plain ring, ring / bf16 plain ring: {parts} (ring at most {K3_BF16_RATIO} x "
              f"plain)")
        del plain, exact

        corpus = synthetic_corpus(cfg, n_files=2, seconds=30.0, seed=0, device=dev)
        mel, mask, em = place_batch(next(iter(BatchIterator(corpus, cfg.train.batch_size,
                                                            prefetch=0))), dev)
        steps, losses = {}, {}
        for name, step_mesh, time_sharded in (("unsharded", None, False),
                                              ("sequence parallel", mesh, True),
                                              ("data parallel", mesh, False)):
            model = build_model(cfg.model, cfg.grid, device=dev, seed=0)
            optimizer = make_optimizer(model.parameters(), cfg.train.learning_rate,
                                       cfg.train.weight_decay)
            steps[name] = (make_train_step(model, SELDLossFn(cfg.loss, cfg.grid), optimizer,
                                           cfg.grid.num_classes, mesh=step_mesh,
                                           time_sharded=time_sharded),
                           create_train_state(model, optimizer))
            k5.fwd_launches = k5.bwd_dq_launches = k5.bwd_dkv_launches = 0
            step, state = steps[name]
            losses[name] = step(state, mel, mask, em, (0, 1))[1]["loss"].item()
            torch.cuda.synchronize()
            ring = (k5.fwd_launches, k5.bwd_dq_launches, k5.bwd_dkv_launches)
            if ring != ((blocks,) * 3 if time_sharded else (0, 0, 0)):
                raise AssertionError(f"{name} step: K5's K3 launches {ring}")
            rel = abs(losses[name] - losses["unsharded"]) / abs(losses["unsharded"])
            if not rel <= SP_LOSS_RTOL:
                raise AssertionError(f"{name} first-step loss {losses[name]} against the "
                                     f"unsharded {losses['unsharded']}: {rel:.3e} relative")
            print(f"[SP] {name} first train step at T=1000: loss {losses[name]:.9f} "
                  f"(relative to the unsharded step {rel:.3e}); K5's K3 launches {ring}")
        times = defaultdict(list)
        for turn in range(20):  # 18 timed: host time spreads by 10-20 %
            order = list(steps.items()) if turn % 2 == 0 else list(reversed(steps.items()))
            for name, (step, state) in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, mel, mask, em, (0, 1))
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        for name, v in times.items():
            print(f"[SP] {name} train step, batch {cfg.train.batch_size} x 1000 frames: median "
                  f"{np.median(v[2:]):.2f} ms of {', '.join(f'{x:.1f}' for x in v[2:])}")
        unsharded_ms = np.median(times["unsharded"][2:])
        print(f"[SP] over the unsharded step (medians): sequence parallel "
              f"{np.median(times['sequence parallel'][2:]) - unsharded_ms:+.2f} ms, data "
              f"parallel {np.median(times['data parallel'][2:]) - unsharded_ms:+.2f} ms")
        del steps
    finally:
        dist.destroy_process_group()

    runs = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for shard_time in ("true", "false"):
            base = Path(tmp) / f"sp_{shard_time}"
            args = ["train", "--synthetic", f"data.base_path={base}",
                    f"window.window_seconds={LONG_WINDOW_SECONDS}", "train.num_epochs=1",
                    "train.save_every_n_epochs=1", "mesh.enable=on",
                    f"mesh.shard_time={shard_time}"]
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "1", str(ROOT / "chip_smoke.py"), "--sp-worker", *args],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            lines = [x for x in res.stdout.splitlines() if x.startswith("[sp-worker] ")]
            if res.returncode != 0 or len(lines) != 1:
                raise AssertionError(f"torchrun cli train mesh.shard_time={shard_time}: rc "
                                     f"{res.returncode}\n{res.stdout[-3000:]}\n"
                                     f"{res.stderr[-6000:]}")
            counts = json.loads(lines[0].split(" ", 1)[1])
            (record,) = [json.loads(x) for x in (base / "checkpoints" / "metrics.jsonl")
                         .read_text().splitlines()]
            rel = abs(record["train"]["loss"] - long_train_loss) / abs(long_train_loss)
            print(f"[SP] torchrun --nproc-per-node 1 chip_smoke.py --sp-worker train "
                  f"mesh.enable=on mesh.shard_time={shard_time} at T=1000, 1 epoch in "
                  f"{wall:.1f} s: train loss {record['train']['loss']:.9f} (phase 7's "
                  f"unsharded run {long_train_loss:.9f}, {rel:.3e} relative), test "
                  f"{record['test']['loss']:.6f}; launches {json.dumps(counts)}")
            if not rel <= SP_EPOCH_RTOL:
                raise AssertionError(f"sharded cli train's epoch loss {record['train']['loss']}"
                                     f" against the unsharded {long_train_loss}")
            runs[shard_time] = counts
    sp, dp = runs["true"], runs["false"]
    if not (sp["k5_fwd"] > 0 and sp["k5_dq"] > 0 and sp["k5_fwd"] == sp["k3_fwd"]
            and sp["k5_dq"] == sp["k3_dq"] == sp["k5_dkv"] == sp["k3_dkv"]
            and sp["k5_fwd"] % blocks == 0):
        raise AssertionError(f"sequence-parallel cli train did not run every attention "
                             f"through K5: {sp}")
    if dp["k5_fwd"] or dp["k5_dq"] or dp["k3_fwd"] != sp["k3_fwd"]:
        raise AssertionError(f"data-parallel cli train: {dp} (K3 directly, K5 never)")
    return sp


TTA_MARGIN = 1e-3  # tests/test_torch_predict.py::MARGIN: a top-2 gap the float32 sums can reorder
STREAM_CHUNKINGS = (("1 s", None), ("0.37 s", 0.37), ("whole", 0.0))  # None: predict_file's split


def seeded_checkpoint(path: Path, overrides: list[str], device: torch.device,
                      seed: int = 0) -> Path:
    """A model of Config() with the overrides, seeded on `device`, saved at
    path."""
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import save_checkpoint

    cfg = parse_overrides(Config(), overrides)
    model = build_model(cfg.model, cfg.grid, device=device, seed=seed,
                        in_channels=feature_channels(cfg.features.feature_set))
    save_checkpoint(path, model, cfg)
    return path


def chunked(wave: np.ndarray, seconds, sr: int) -> list:
    """The clip's chunks: predict_file's 1 s np.array_split (None), chunks
    of `seconds`, or the whole clip (0)."""
    if seconds is None:
        return np.array_split(wave, max(1, wave.shape[1] // sr), axis=1)
    if not seconds:
        return [wave]
    size = int(seconds * sr)
    return [wave[:, i:i + size] for i in range(0, wave.shape[1], size)]


def stream_once(pred, chunks, overlap: float) -> tuple[np.ndarray, int, dict]:
    """One StreamingSession over the chunks: (classes, the frame blocks it
    featurized, the launches counted from its first push to its flush)."""
    from seld_tpu_torch.stream import StreamingSession

    s = StreamingSession(pred, overlap=overlap)
    reset_launches()
    parts = [c for chunk in chunks for _, c in s.push(chunk)]
    parts += [c for _, c in s.flush()]
    counts = launches()
    return np.concatenate(parts), s.frame_blocks, counts


def timed_predict(fn, reps: int = 5) -> tuple[float, list[float], float]:
    """(median ms, the ms of each call, peak device GiB of one call) of fn()."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times, torch.cuda.max_memory_allocated() / 2**30


def padded_windows(pred, wave) -> tuple[torch.Tensor, int]:
    """The clip's non-overlapping windows as predict_waveform tiles them,
    and its frame count."""
    from seld_tpu_torch.data.corpus import compute_mel_features

    mel = compute_mel_features(wave, pred.cfg.features, pred.device)
    t, win = mel.shape[0], pred.win
    n = -(-t // win)
    mel = torch.cat([mel, mel.new_zeros((n * win - t, *mel.shape[1:]))])
    return mel.reshape(n, win, *mel.shape[1:]), t


def reference_tta_probs(pred, wave) -> torch.Tensor:
    """The plain loop of TTA16 for a grid predictor: each batch of windows
    (zero-padded to batch_windows, as _batched pads it) through _raw_apply
    once per permuted and signed view, each view's logits mapped back to
    the original cells on the host in float64 (softmax, inverse cell
    gather) and averaged -> (T, M, G) float64 mean probabilities."""
    from seld_tpu_torch.features.acs import acs_tables

    grid = pred.cfg.grid
    cell_gather, ch_perm, ch_sign = acs_tables(grid.n_el, grid.n_az, "mel_iv")
    windows, t = padded_windows(pred, wave)
    bw = pred.batch_windows
    acc = torch.zeros((windows.shape[0], pred.win, grid.num_classes, grid.n_cells),
                      dtype=torch.float64)
    for start in range(0, windows.shape[0], bw):
        batch = windows[start:start + bw]
        valid = batch.shape[0]
        batch = torch.cat([batch, batch.new_zeros((bw - valid, *batch.shape[1:]))])
        for v in range(16):
            perm = torch.as_tensor(ch_perm[v], dtype=torch.long, device=batch.device)
            sign = torch.as_tensor(ch_sign[v], device=batch.device)
            out = pred._raw_apply(batch[:, :, perm] * sign[:, None])[:valid].double().cpu()
            inverse = torch.from_numpy(np.argsort(cell_gather[v]))
            acc[start:start + valid] += torch.softmax(out, dim=2)[..., inverse]
    return (acc / 16.0).reshape(-1, grid.num_classes, grid.n_cells)[:t]


def same_decisions(tag: str, got: np.ndarray, want: np.ndarray, margin: np.ndarray) -> int:
    """Cells that differ, none of them outside the TTA_MARGIN band."""
    differ = got != want
    outside = int((differ & (margin > TTA_MARGIN)).sum())
    if outside or got.shape != want.shape:
        raise AssertionError(f"{tag}: {outside} cells differ outside the {TTA_MARGIN} band")
    return int(differ.sum())


def count_forwards(pred) -> list:
    """A list that gets the batch size of every model forward of pred."""
    calls = []
    pred.model.register_forward_hook(lambda m, i, o: calls.append(i[0].shape[0]))
    return calls


def serving_tta(dev, path: Path, wave, tag: str) -> dict:
    """TTA on a mel_iv flagship: identity TTA bit-equal to the plain predict;
    TTA16 against reference_tta_probs; fold 2 against it; exact launches
    (K4 once, 16 x batches forwards / fold, K3 forward 4 a forward at
    T >= 512); a stream under TTA bit-equal to offline TTA; plain and TTA16
    predicts timed."""
    from seld_tpu_torch.infer import SELDPredictor

    sr = 24_000
    pred = SELDPredictor(path, batch_windows=8, device=dev)
    calls = count_forwards(pred)
    plain = pred.predict_waveform(wave).classes
    plain_ms, plain_times, plain_gib = timed_predict(lambda: pred.predict_waveform(wave))
    windows = -(-(1 + wave.shape[1] // pred.cfg.features.hop_length) // pred.win)
    batches = -(-windows // pred.batch_windows)
    flash = pred.win >= 512
    found = {}

    pred.tta((0,))
    if not np.array_equal(pred.predict_waveform(wave).classes, plain):
        raise AssertionError(f"{tag} identity TTA differs from the plain predict")

    ref = reference_tta_probs(pred, wave)
    ref_classes = ref.argmax(dim=1).to(torch.int8).numpy()
    top = torch.topk(ref, 2, dim=1).values
    margin = (top[:, 0] - top[:, 1]).numpy()
    results = {}
    for fold in (1, 2):
        pred.tta(None, fold=fold)
        pred.predict_waveform(wave)  # warm-up
        calls.clear()
        reset_launches()
        results[fold] = pred.predict_waveform(wave).classes
        counts = launches()
        forwards = 16 * batches // fold
        want = only(k4=1, k3_fwd=4 * forwards if flash else 0)
        if counts != want or len(calls) != forwards or set(calls) != {8 * fold}:
            raise AssertionError(f"{tag} TTA16 fold {fold}: launches {counts} (want {want}), "
                                 f"{len(calls)} forwards of batch {set(calls)} (want {forwards})")
        found[f"TTA16 fold {fold}"] = counts
        differ = same_decisions(f"{tag} TTA16 fold {fold} against the float64 reference loop",
                                results[fold], ref_classes, margin)
        print(f"{tag} TTA16 fold {fold}: {windows} windows in {batches} batches of 8 -> "
              f"{len(calls)} forwards of batch {8 * fold}; launches {counts}; against the "
              f"float64 reference loop {differ} of {ref_classes.size} cells differ, all inside "
              f"the {TTA_MARGIN} top-2 band ({int((margin <= TTA_MARGIN).sum())} cells in it)")
    differ = same_decisions(f"{tag} TTA16 fold 2 against fold 1", results[2], results[1], margin)
    print(f"{tag} TTA16 fold 2 against fold 1: {differ} cells differ, all inside the band")

    pred.tta(None)
    streamed, frame_blocks, counts = stream_once(pred, chunked(wave, None, sr), 0.0)
    if not np.array_equal(streamed, results[1]) or counts["k4"] != frame_blocks:
        raise AssertionError(f"{tag} stream under TTA16: launches {counts}, frame blocks "
                             f"{frame_blocks}, equal {np.array_equal(streamed, results[1])}")
    found["TTA16 stream 1 s"] = counts
    tta_ms, tta_times, tta_gib = timed_predict(lambda: pred.predict_waveform(wave))
    print(f"[stream] {tag} TTA16 stream in 1 s chunks bit-equal to offline TTA16 "
          f"({streamed.size} cells, agreement 100 %); K4 {counts['k4']} launches = "
          f"{frame_blocks} frame blocks")
    print(f"{tag} predict of the {CLIP_SECONDS} s clip at T = {pred.win}: plain {plain_ms:.2f} ms "
          f"(median of {', '.join(f'{x:.2f}' for x in plain_times)}; peak {plain_gib:.2f} GiB), "
          f"TTA16 {tta_ms:.2f} ms (median of {', '.join(f'{x:.2f}' for x in tta_times)}; peak "
          f"{tta_gib:.2f} GiB): {tta_ms / plain_ms:.1f}x")
    found["ms"] = {"plain": plain_ms, "tta16": tta_ms, "plain_peak_gib": plain_gib,
                   "tta16_peak_gib": tta_gib}
    return found


def phase_serving(dev: torch.device) -> dict:
    """Phase 15: the predictor side of serving on the full-width flagship
    (seeded weights saved as checkpoints): F3's tiny clips, streaming of
    the 60 s clip (K1 / K4 once per frame block) bit-equal to offline,
    TTA at T = 250 and 1000, the ACCDOA families under TTA, and the CLI
    chain train -> average-ckpts -> predict -> eval --tta -> calibrate
    --tta -> predict --calibration -> predict --stream --tta. Returns
    every path's launches."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.config import Config
    from seld_tpu_torch.data.audio import load_wav
    from seld_tpu_torch.data.synthetic import synthetic_raw_files
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.stream import stream_predict

    base = Config()
    sr = base.features.sample_rate
    wave = (0.1 * np.random.default_rng(0).standard_normal((4, CLIP_SECONDS * sr))
            ).astype(np.float32)
    found = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        mel_path = seeded_checkpoint(root / "mel.pt", [], dev)
        iv_path = seeded_checkpoint(root / "mel_iv.pt", ["features.feature_set=mel_iv"], dev)
        long_path = seeded_checkpoint(root / "long.pt", [
            "features.feature_set=mel_iv", f"window.window_seconds={LONG_WINDOW_SECONDS}"], dev)
        for feature_set, path in (("mel", mel_path), ("mel_iv", iv_path)):
            tag = f"[serve {feature_set}]"
            key = "k1" if feature_set == "mel" else "k4"
            pred = SELDPredictor(path, batch_windows=8, device=dev)
            for n in (100, 479, 481, 700):  # F3: tiny clips
                clip = wave[:, :n]
                offline = pred.predict_waveform(clip).classes
                if (offline.shape != (1 + n // 480, base.grid.n_cells)
                        or not np.array_equal(stream_predict(pred, [clip]).classes, offline)):
                    raise AssertionError(f"{tag} F3: the {n}-sample clip")
            print(f"{tag} F3: predicts of 100-, 479-, 481- and 700-sample clips answer, each "
                  f"equal to stream_predict of the same clip")
            for overlap in (0.0, 0.5):
                offline = pred.predict_waveform(wave, overlap=overlap).classes
                for name, seconds in STREAM_CHUNKINGS:
                    streamed, frame_blocks, counts = stream_once(
                        pred, chunked(wave, seconds, sr), overlap)
                    same_shape = streamed.shape == offline.shape
                    agree = float((streamed == offline).mean()) if same_shape else 0.0
                    differ = int((streamed != offline).sum()) if same_shape else -1
                    print(f"[stream] {feature_set} overlap {overlap:g} chunks {name}: "
                          f"{offline.shape[0]} frames x {offline.shape[1]} cells, agreement "
                          f"{100 * agree:.4f} % ({differ} cells differ); {key.upper()} "
                          f"launches {counts[key]} = frame blocks {frame_blocks}; launches "
                          f"{counts}")
                    if agree != 1.0 or counts != only(**{key: frame_blocks}):
                        raise AssertionError(f"{tag} stream overlap {overlap} chunks {name}")
                    found[f"{feature_set} stream overlap {overlap:g} chunks {name}"] = counts
            off_ms, off_times, off_gib = timed_predict(lambda: pred.predict_waveform(wave))
            st_ms, st_times, st_gib = timed_predict(
                lambda: stream_predict(pred, chunked(wave, None, sr)))
            print(f"{tag} {CLIP_SECONDS} s clip: offline {off_ms:.2f} ms (median of "
                  f"{', '.join(f'{x:.2f}' for x in off_times)}; peak {off_gib:.2f} GiB), "
                  f"streamed in 1 s chunks {st_ms:.2f} ms (median of "
                  f"{', '.join(f'{x:.2f}' for x in st_times)}; peak {st_gib:.2f} GiB)")
            found[f"{feature_set} ms"] = {"offline": off_ms, "streamed": st_ms,
                                          "offline_peak_gib": off_gib, "streamed_peak_gib": st_gib}
            del pred

        for path, tag in ((iv_path, "[tta T = 250]"), (long_path, "[tta T = 1000]")):
            for k, v in serving_tta(dev, path, wave, tag).items():
                found[f"{tag.strip('[]')} {k}"] = v

        for model_type in ("accdoa_conformer", "multi_accdoa_conformer"):
            path = seeded_checkpoint(root / f"{model_type}.pt", [
                f"model.model_type={model_type}", "features.feature_set=mel_iv"], dev)
            pred = SELDPredictor(path, batch_windows=8, device=dev, accdoa_threshold=0.3)
            plain = pred.predict_waveform(wave).classes
            ident = pred.tta((0,)).predict_waveform(wave).classes
            pred.tta(None)
            reset_launches()
            full = pred.predict_waveform(wave).classes
            counts = launches()
            if not np.array_equal(ident, plain) or counts != only(k4=1) or full.max() > 13:
                raise AssertionError(f"[{model_type}] TTA: identity equal "
                                     f"{np.array_equal(ident, plain)}, launches {counts}")
            print(f"[{model_type}] identity TTA equal to the plain decode "
                  f"({int((plain != 13).sum())} active cells); TTA16 "
                  f"({'votes' if model_type.startswith('multi') else 'mean vectors'}): "
                  f"{int((full != 13).sum())} active cells, launches {counts}")
            found[f"{model_type} TTA16"] = counts
            del pred

        # the command line on a short mel_iv flagship run
        (clip_wav,), _ = synthetic_raw_files(root / "clip", base, n_files=1,
                                             seconds=float(CLIP_SECONDS), seed=2)
        work = root / "run" / "checkpoints"
        args = [f"data.base_path={root / 'run'}", "features.feature_set=mel_iv"]
        fps = sr // base.features.hop_length
        eval_steps = -(-(20 * fps // base.window.hop_frames(base.features))
                       // base.train.batch_size)
        reset_launches()
        t0 = time.perf_counter()
        if cli.main(["train", "--synthetic", *args, "train.num_epochs=2",
                     "train.save_every_n_epochs=1"]) != 0:
            raise AssertionError("cli train failed")
        trained = launches()
        rolling = sorted((work / "rolling").glob("epoch_*.pt"))
        if trained["k4"] != 3 or len(rolling) < 2:
            raise AssertionError(f"cli train: launches {trained}, rolling {rolling}")
        print(f"[cli] train --synthetic features.feature_set=mel_iv, 2 epochs in "
              f"{time.perf_counter() - t0:.1f} s: launches {trained}; rolling checkpoints "
              f"{[p.name for p in rolling]}")
        if cli.main(["average-ckpts", "--checkpoint-dir", str(work), "--output-dir",
                     str(root / "swa"), "--last", "2"]) != 0:
            raise AssertionError("cli average-ckpts failed")
        (avg,) = (root / "swa" / "best").glob("epoch_*.pt")
        sources = torch.load(avg, map_location="cpu", weights_only=True)["meta"]["swa_sources"]

        def predict_csv(name, checkpoint, *flags):
            out = root / f"out_{len(found)}"
            reset_launches()
            if cli.main(["predict", "--checkpoint", str(checkpoint), "--wavs", clip_wav,
                         "--out", str(out), *flags]) != 0:
                raise AssertionError(f"cli predict {name} failed")
            counts = launches()
            (csv,) = (out / "predictions").glob("*.csv")
            found[f"cli predict {name}"] = counts
            return csv.read_text(), counts

        _, counts = predict_csv("swa", avg)
        if counts != only(k4=1) or sources != [1, 2]:
            raise AssertionError(f"predict of the average: launches {counts}, sources {sources}")
        print(f"[cli] average-ckpts --last 2 -> {avg.relative_to(root)} (swa_sources {sources}); "
              f"predict from it: launches {counts}")
        reset_launches()
        report = cli_json(["eval", "--synthetic", *args, "--tta", "--bg-bias-sweep", "0,1,2",
                           "--num-visualizations", "0"])
        evaluated = launches()
        swept = report["bg_bias_sweep"]["metrics"]
        if evaluated != only(k4=3, k2_fwd=eval_steps) or len(swept) != 3:
            raise AssertionError(f"cli eval --tta: launches {evaluated}")
        found["cli eval --tta"] = evaluated
        print(f"[cli] eval --tta --bg-bias-sweep 0,1,2: launches {evaluated} ({eval_steps} eval "
              f"steps: K2 forward {evaluated['k2_fwd'] // eval_steps} a step, on the plain "
              f"forward's loss); test loss {report['test_loss']:.6f}; SELD_error by bias "
              f"{ {k: round(v['SELD_error'], 4) for k, v in swept.items()} }")
        reset_launches()
        calib = cli_json(["calibrate", "--synthetic", *args, "--tta"])
        calibrated = launches()
        if (calibrated != only(k4=3, k2_fwd=2 * eval_steps) or not calib["tta"]
                or calib["tta_transforms"] != list(range(16))):
            raise AssertionError(f"cli calibrate --tta: launches {calibrated}, {calib}")
        found["cli calibrate --tta"] = calibrated
        print(f"[cli] calibrate --tta: launches {calibrated}; bg_bias {calib['bg_bias']}, "
              f"median_filter {calib['median_filter']}, tta {calib['tta']}")
        (best,) = (work / "best").glob("epoch_*.pt")
        by_file, counts = predict_csv("--calibration (tta)", best, "--calibration",
                                      str(work / "decode_calibration.json"))
        by_flags, _ = predict_csv("--tta with its knobs", best, "--tta", "--bg-bias",
                                  str(calib["bg_bias"]),
                                  "--median-filter", str(calib["median_filter"]))
        if by_file != by_flags or counts != only(k4=1):
            raise AssertionError(f"predict --calibration: launches {counts}, CSV equal to "
                                 f"--tta with the knobs {by_file == by_flags}")
        print(f"[cli] predict --calibration (TTA on from the file): launches {counts}; CSV "
              f"equal to predict --tta --bg-bias {calib['bg_bias']} --median-filter "
              f"{calib['median_filter']}")
        # the short run predicts background everywhere: the seeded flagship's
        # CSV has rows to compare
        offline_csv, _ = predict_csv("--tta --overlap 0.5", iv_path, "--tta", "--overlap",
                                     "0.5")
        stream_csv, counts = predict_csv("--stream --tta --overlap 0.5", iv_path, "--stream",
                                         "--tta", "--overlap", "0.5")
        if stream_csv != offline_csv or not stream_csv or counts["k4"] < 2:
            raise AssertionError(f"predict --stream --tta --overlap 0.5: launches {counts}, "
                                 f"CSV equal {stream_csv == offline_csv}")
        print(f"[cli] predict --stream --tta --overlap 0.5 of the seeded mel_iv flagship: CSV "
              f"equal to --tta --overlap 0.5 ({len(stream_csv.splitlines())} rows); launches "
              f"{counts}")
    return found


SLOT_CASES = (("mel", 250), ("mel_iv", 250), ("mel", 1000), ("mel_iv", 1000))


def clip_waves(n: int, sr: int = 24_000) -> list:
    """n seeded 60 s clips, the first of them the clip every phase serves."""
    return [(0.1 * np.random.default_rng(seed).standard_normal((4, CLIP_SECONDS * sr))
             ).astype(np.float32) for seed in range(n)]


def slot_check(pred, windows: torch.Tensor, tag: str) -> dict:
    """Does a row's output depend on its batch slot, or on the rows beside
    it? One batch of batch_windows windows through _raw_apply (float32
    logits), then: the same batch again (determinism); the batch permuted
    (reversed, then rolled by 3); each row alone among zeros in every slot;
    each row in its own slot among another stream's windows. Every
    comparison is bit for bit against the row in the first batch."""
    bw = pred.batch_windows
    rows, others = windows[:bw], windows[bw:2 * bw]
    base = pred._raw_apply(rows)
    again = bool(torch.equal(pred._raw_apply(rows), base))
    perm = torch.roll(torch.arange(bw - 1, -1, -1), 3).to(rows.device)
    permuted = pred._raw_apply(rows[perm])
    diffs = [(permuted - base[perm]).abs().max().item()]
    own_zeros = own_beside = other_slots = 0
    for i in range(bw):
        for slot in range(bw):
            batch = torch.zeros_like(rows)
            batch[slot] = rows[i]
            got = pred._raw_apply(batch)[slot]
            diffs.append((got - base[i]).abs().max().item())
            if slot == i:
                own_zeros += bool(torch.equal(got, base[i]))
            else:
                other_slots += bool(torch.equal(got, base[i]))
        mixed = others.clone()
        mixed[i] = rows[i]
        own_beside += bool(torch.equal(pred._raw_apply(mixed)[i], base[i]))
    found = {"deterministic": again, "permuted": bool(torch.equal(permuted, base[perm])),
             "own_slot_among_zeros": own_zeros, "own_slot_among_others": own_beside,
             "other_slots": other_slots,
             "neighbours_matter": own_zeros < bw or own_beside < bw,
             "slot_matters": other_slots < bw * (bw - 1)}
    print(f"[slots] {tag} batch of {bw}: the batch twice bit-equal {again}; permuted "
          f"{found['permuted']}; each row in its own slot among zeros bit-equal {own_zeros} of "
          f"{bw}, among another stream's windows {own_beside} of {bw}; alone in another slot "
          f"{other_slots} of {bw * (bw - 1)}; largest logit difference {max(diffs):.3e}")
    return found


def program_ops(path: Path) -> int:
    """The nodes of an exported program that call K3's forward operator."""
    with open(path, "rb") as f:
        graph = torch.export.load(f).graph
    return sum("flash_attention_fwd" in str(n.target) for n in graph.nodes)


def k3_host_us_by_route(dev) -> dict:
    """Host µs of one K3 forward at the main path's shape (B*H = 128,
    T = 1000, Dh = 64, bf16), no synchronize between calls: launch_forward
    (the eager route, as phase 3 times it) and the operator an exported
    program calls, in turns."""
    from seld_tpu_torch.ops import flash_attention as k3

    q, k, v, _ = k3_case(dev, 16, 8, 1000, 64, torch.bfloat16, seed=3)
    scale = 64 ** -0.5
    routes = {"launch_forward": lambda: k3.launch_forward(q, k, v, scale),
              "operator": lambda: torch.ops.seld_tpu_torch.flash_attention_fwd(q, k, v, scale)}
    found = defaultdict(list)
    with torch.no_grad():
        eager = k3.launch_forward(q, k, v, scale)
        via_op = routes["operator"]()
        if not all(torch.equal(a, b) for a, b in zip(eager, via_op)):
            raise AssertionError("K3's operator differs from launch_forward")
        for name in ("launch_forward", "operator", "operator", "launch_forward"):
            found[name].append(host_us(routes[name]))
    print(f"[K3 op] host µs of one forward at B*H = 128, T = 1000, Dh = 64, bf16 (200 calls "
          f"each, in turns): launch_forward {found['launch_forward']}, the operator "
          f"seld_tpu_torch::flash_attention_fwd {found['operator']}; outputs bit-equal")
    return {k: float(np.median(v)) for k, v in found.items()}


def export_check(dev, live, export, out: Path, waves: list, tag: str) -> dict:
    """export() writes the artifact `out` of the checkpoint `live` serves;
    then: K3's operator in both programs' graphs (4 at T >= 512, else 0),
    the artifact-backed predict of the 60 s clip bit-equal to the
    checkpoint-backed one at overlap 0 and 0.5, its launches (K1 or K4 once,
    K3 forward 4 a forward at T >= 512), both predicts timed, and the
    artifact's size on disk."""
    from seld_tpu_torch.infer import SELDPredictor

    t0 = time.perf_counter()
    export()
    export_s = time.perf_counter() - t0
    art = SELDPredictor.from_artifact(out, device=dev)
    flash = live.win >= 512
    ops = (program_ops(out), program_ops(Path(f"{out}.probs")))
    if ops != ((4, 4) if flash else (0, 0)):
        raise AssertionError(f"{tag} K3's operator in the programs' graphs: {ops}")
    wave = waves[0]
    for overlap in (0.0, 0.5):
        if not np.array_equal(art.predict_waveform(wave, overlap=overlap).classes,
                              live.predict_waveform(wave, overlap=overlap).classes):
            raise AssertionError(f"{tag} artifact predict at overlap {overlap} differs")
    key = "k1" if live.cfg.features.feature_set == "mel" else "k4"
    windows = -(-(1 + wave.shape[1] // live.cfg.features.hop_length) // live.win)
    forwards = -(-windows // 8)
    reset_launches()
    art.predict_waveform(wave)
    counts = launches()
    if counts != only(**{key: 1, "k3_fwd": 4 * forwards if flash else 0}):
        raise AssertionError(f"{tag} artifact predict launches {counts}")
    art_ms, art_times, art_gib = timed_predict(lambda: art.predict_waveform(wave))
    live_ms, live_times, live_gib = timed_predict(lambda: live.predict_waveform(wave))
    size = sum(Path(f"{out}{s}").stat().st_size for s in ("", ".probs", ".json"))
    print(f"[export] {tag}: export {export_s:.1f} s; K3's operator in the graphs {ops}; "
          f"artifact predict bit-equal to the checkpoint's at overlap 0 and 0.5; launches "
          f"{counts} ({forwards} forwards); {CLIP_SECONDS} s clip: artifact {art_ms:.2f} ms "
          f"(median of {', '.join(f'{x:.2f}' for x in art_times)}; peak {art_gib:.2f} GiB), "
          f"checkpoint {live_ms:.2f} ms (median of {', '.join(f'{x:.2f}' for x in live_times)}; "
          f"peak {live_gib:.2f} GiB); artifact on disk {size / 1e6:.1f} MB")
    return {"launches": counts, "artifact_ms": art_ms, "checkpoint_ms": live_ms,
            "megabytes": size / 1e6, "export_s": export_s}


def phase_artifact_checks(dev: torch.device, root: Path) -> tuple[dict, list]:
    """Phase 16's first half: the slot check, K3's host µs by route and the
    exports at T = 250 and 1000 on mel and mel_iv (SLOT_CASES' order; the
    T = 1000 mel one through `cli export` of a run's best checkpoint, the
    others through export_serving); returns ({tag: export_check's dict,
    "slots": the slot finding}, [(checkpoint, its predictor)] in
    SLOT_CASES' order; each one's artifact is root/<its stem>.pt2)."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.export import export_serving
    from seld_tpu_torch.infer import SELDPredictor

    waves = clip_waves(4)
    found, preds, slots = {}, {}, {}
    for feature_set, t in SLOT_CASES:
        tag = f"{feature_set} T = {t}"
        path = seeded_checkpoint(root / f"{feature_set}_{t}.pt", [
            f"features.feature_set={feature_set}",
            f"window.window_seconds={t * 0.02:g}"], dev)
        preds[tag] = (path, SELDPredictor(path, batch_windows=8, device=dev))
        windows = torch.cat([padded_windows(preds[tag][1], w)[0] for w in waves])
        slots[tag] = slot_check(preds[tag][1], windows, tag)
        del windows
    slot_matters = any(f["slot_matters"] for f in slots.values())
    neighbours_matter = any(f["neighbours_matter"] for f in slots.values())
    print(f"[slots] finding, at T = 250 and 1000 on mel and mel_iv: a row's output "
          f"{'DEPENDS' if slot_matters else 'does not depend'} on its batch slot, and "
          f"{'DEPENDS' if neighbours_matter else 'does not depend'} on the rows beside it")
    found["k3 host us"] = k3_host_us_by_route(dev)
    for i, (tag, (path, pred)) in enumerate(preds.items()):
        out = root / f"{path.stem}.pt2"
        if i == 2:  # the CLI: the run's newest best checkpoint, no --checkpoint
            run = root / "run"
            (run / "checkpoints" / "best").mkdir(parents=True)
            shutil.copy(path, run / "checkpoints" / "best" / "epoch_0003.pt")
            def export(argv=("export", f"data.base_path={run}", "--out", str(out))):
                if cli.main(list(argv)) != 0:
                    raise AssertionError("cli export failed")
        else:
            export = lambda path=path, out=out: export_serving(path, out, batch_windows=8,
                                                               device=dev)
        found[tag] = export_check(dev, pred, export, out, waves, f"[{tag}]")
    found["slots"] = slots
    return found, list(preds.values())


def frame_blocks_of(pred, chunks, overlap: float) -> int:
    """The frame blocks (K1 or K4 launches) a StreamingSession makes of the
    chunks, counted by a session that runs no window."""
    from seld_tpu_torch.stream import StreamingSession

    s = StreamingSession(pred, overlap=overlap)
    s._emit_ready = lambda final: []
    for chunk in chunks:
        s.push(chunk)
    s.flush()
    return s.frame_blocks


def serve_streams(pred, wave, chunk_seconds: list, overlap: float, batch: bool,
                  tag: str, wait_s: float = 0.0) -> dict:
    """A SELDServer on 127.0.0.1:0 serving one stream of the clip per entry
    of chunk_seconds (that stream's chunk length), all at once, each through
    stream_client in its own thread: every stream's classes equal to the
    offline predict; K1 or K4 launches equal to the streams' frame blocks
    and K3 forward 4 a model forward at T >= 512; each stream's wall ms and
    the audio-seconds served per second."""
    import threading

    from seld_tpu_torch.serve import SELDServer, stream_client

    sr = pred.cfg.features.sample_rate
    key = "k1" if pred.cfg.features.feature_set == "mel" else "k4"
    offline = pred.predict_waveform(wave, overlap=overlap).classes
    streams = [chunked(wave, c, sr) for c in chunk_seconds]
    blocks = sum(frame_blocks_of(pred, chunks, overlap) for chunks in streams)
    forwards = []
    hook = pred.model.register_forward_hook(lambda m, i, o: forwards.append(1)) \
        if pred.model is not None else None
    server = SELDServer(pred, port=0, batch_streams=batch, batch_wait_s=wait_s)
    serving = server.serve_background()
    results, walls = {}, {}

    def run(k):
        t0 = time.perf_counter()
        results[k] = stream_client("127.0.0.1", server.port, streams[k], overlap=overlap,
                                   timeout=300)[0]
        walls[k] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(streams))]
    try:
        reset_launches()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        total_s = time.perf_counter() - t0
        counts = launches()
    finally:
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
        if hook is not None:
            hook.remove()
    if any(t.is_alive() for t in threads) or len(results) != len(streams):
        raise AssertionError(f"{tag}: a stream did not finish")
    for k, classes in results.items():
        if classes.shape != offline.shape or not np.array_equal(classes, offline):
            raise AssertionError(f"{tag}: stream {k} differs from the offline predict")
    calls = server.batcher.batches_run if batch else len(forwards)
    want = only(**{key: blocks, "k3_fwd": 4 * calls if pred.win >= 512 else 0})
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, want {want}")
    served = len(streams) * wave.shape[1] / sr / total_s
    print(f"[serve] {tag}: {len(streams)} stream(s) of the {CLIP_SECONDS} s clip in "
          f"{'/'.join(f'{c:g}' for c in chunk_seconds)} s chunks, overlap {overlap:g}, "
          f"{f'batched, wait {wait_s * 1e3:g} ms' if batch else 'device lock'}: every stream "
          f"equal to offline "
          f"({offline.size} cells each); {key.upper()} {counts[key]} launches = frame blocks "
          f"{blocks}; {calls} forwards ({'batches_run' if batch else 'solo'}), K3 forward "
          f"{counts['k3_fwd']}; per-stream wall ms "
          f"{', '.join(f'{walls[k]:.1f}' for k in sorted(walls))}; "
          f"{served:.1f} audio-s served per s")
    return {"launches": counts, "forwards": calls, "wall_ms": [walls[k] for k in sorted(walls)],
            "audio_s_per_s": served}


def cli_chain(dev, art: Path, wave) -> dict:
    """`cli serve --artifact ART --port 0 --max-streams 2 --batch-streams`
    in a new process (which loads the artifact alone), driven by two
    concurrent streams of stream_client: both equal to the artifact's
    offline predict in this process, and the server exits by itself."""
    import threading

    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.serve import stream_client

    offline = SELDPredictor.from_artifact(art, device=dev).predict_waveform(wave).classes
    proc = subprocess.Popen([sys.executable, "-m", "seld_tpu_torch.cli", "serve", "--artifact",
                             str(art), "--port", "0", "--max-streams", "2", "--batch-streams"],
                            cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        port = None
        t0 = time.perf_counter()
        for line in proc.stdout:  # the CLI logs to standard output
            found = re.search(r"Serving \S+ on 127\.0\.0\.1:(\d+)", line)
            if found:
                port = int(found.group(1))
                break
        if port is None:
            raise AssertionError("cli serve printed no Serving line")
        ready_s = time.perf_counter() - t0
        results = {}
        chunks = chunked(wave, None, 24_000)
        threads = [threading.Thread(target=lambda k=k: results.setdefault(
            k, stream_client("127.0.0.1", port, chunks, timeout=300)[0])) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 or len(results) != 2 or not all(np.array_equal(c, offline)
                                                for c in results.values()):
        raise AssertionError(f"cli serve --artifact: rc {rc}, {len(results)} streams")
    print(f"[cli] serve --artifact {art.name} (from cli export) --port 0 --max-streams 2 "
          f"--batch-streams in a new process (ready in {ready_s:.1f} s): two concurrent "
          f"streams of stream_client, each equal to the artifact's offline predict in this "
          f"process; the server exited with rc {rc} after them")
    return {"ready_s": ready_s}


def phase_daemon(dev: torch.device) -> dict:
    """Phase 16: the serving daemon and the artifact on the full-width
    flagship (seeded weights): the slot check, K3's host µs by route, the
    exports at T = 250 and 1000 on mel and mel_iv, the daemon at 1 and 4
    streams with and without batching at overlap 0 and 0.5, 4 streams that
    drift apart, T = 1000 once, and `cli serve` of the T = 1000 artifact
    that `cli export` wrote in a new process. Returns every path's
    launches."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    steps = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        found, ((_, short_mel), _, (long_mel, _), (_, long_iv)) = phase_artifact_checks(dev,
                                                                                     root)
        steps["slot check and exports"] = time.perf_counter() - t_phase
        wave = clip_waves(1)[0]
        for overlap in (0.0, 0.5):
            for n in (1, 4):
                for batch in (False, True):
                    tag = f"mel T = 250 {n} stream{'s' if n > 1 else ''} overlap {overlap:g} " \
                          f"{'batched' if batch else 'solo'}"
                    found[f"serve {tag}"] = serve_streams(short_mel, wave, [1.0] * n, overlap,
                                                          batch, f"[{tag}]")
        mixed = (1.0, 0.7, 1.3, 1.9)  # streams that drift apart: their next slots differ
        for batch in (False, True):
            tag = f"mel T = 250 4 streams mixed chunks {'batched' if batch else 'solo'}"
            found[f"serve {tag}"] = serve_streams(short_mel, wave, list(mixed), 0.0, batch,
                                                  f"[{tag}]")
        solo = found["serve mel T = 250 4 streams mixed chunks solo"]["forwards"]
        batched = found["serve mel T = 250 4 streams mixed chunks batched"]["forwards"]
        if not batched < solo:
            raise AssertionError(f"batching ran {batched} forwards against {solo} solo")
        lockstep = {b: found[f"serve mel T = 250 4 streams overlap 0 {b}"]["forwards"]
                    for b in ("solo", "batched")}
        print(f"[serve] forwards for 4 streams started together: in 1 s chunks "
              f"{lockstep['solo']} solo, {lockstep['batched']} batched; in chunks of "
              f"{'/'.join(f'{c:g}' for c in mixed)} s {solo} solo, {batched} batched")
        found["serve mel_iv T = 1000 4 streams batched"] = serve_streams(
            long_iv, wave, [1.0] * 4, 0.0, True, "[mel_iv T = 1000 4 streams batched]")
        steps["serving"] = time.perf_counter() - t_phase - sum(steps.values())
        found["cli chain"] = cli_chain(dev, root / f"{long_mel.stem}.pt2", wave)
        steps["cli serve"] = time.perf_counter() - t_phase - sum(steps.values())
    print(f"[daemon] phase 16 took {time.perf_counter() - t_phase:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in steps.items())}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return found


INT8_TTA = (0, 5, 10)  # the views of phase 17's int8 TTA predict
INT8_T1000 = ["features.feature_set=mel_iv", f"window.window_seconds={LONG_WINDOW_SECONDS}"]


def int_mm_calls(fn) -> list:
    """The (rows, K, N) of every torch._int_mm call fn() makes."""
    seen, real = [], torch._int_mm

    def recording(a, b):
        seen.append((a.shape[0], a.shape[1], b.shape[1]))
        return real(a, b)

    torch._int_mm = recording
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        torch._int_mm = real
    return seen


def check_int_mm(dev, shapes: list) -> dict:
    """torch._int_mm bit-equal to its float64 plain version at each shape,
    timed against a bf16 torch.matmul of the shape, beside the int8 bound
    (2 m k n at 1,979 TOP/s, or the bytes at 3.35 TB/s); int8_matmul's
    padding at shapes off the GEMM's rules. Returns the ms sums."""
    from seld_tpu_torch.quant import int8_matmul, int8_matmul_reference

    gen = torch.Generator(device=dev).manual_seed(17)
    sums = {"int8": 0.0, "bf16": 0.0, "bound": 0.0}
    for m, k, n in sorted(set(shapes)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        got = torch._int_mm(a, w.t())
        if not torch.equal(got, int8_matmul_reference(a, w)):
            raise AssertionError(f"[int8] _int_mm ({m}, {k}) x ({k}, {n}) differs from its plain "
                                 "version")
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        t8 = kernel_ms(lambda: torch._int_mm(a, w.t()))
        t16 = kernel_ms(lambda: torch.matmul(ab, wb.t()))
        bound = max(2 * m * k * n / INT8_OPS, (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S) * 1e3
        n_calls = shapes.count((m, k, n))
        sums["int8"] += n_calls * t8
        sums["bf16"] += n_calls * t16
        sums["bound"] += n_calls * bound
        print(f"[int8] _int_mm ({m}, {k}) x ({k}, {n}) x {n_calls} a forward: bit-equal to the "
              f"float64 product; {t8:.4f} ms against bf16 matmul {t16:.4f} ms "
              f"({t16 / t8:.2f}x); bound {bound:.4f} ms ({bound / t8:.1%})")
    for m, k, n in ((3, 36, 39), (16, 63, 14), (17, 90, 117), (1000, 36, 64)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        if not torch.equal(int8_matmul(a, w), int8_matmul_reference(a, w)):
            raise AssertionError(f"[int8] int8_matmul ({m}, {k}, {n}) padded differs")
    print(f"[int8] {len(shapes)} _int_mm calls a T = 250 forward at {len(set(shapes))} shapes: "
          f"{sums['int8']:.3f} ms of GEMM against bf16 matmuls' {sums['bf16']:.3f} ms, bound "
          f"{sums['bound']:.3f} ms; int8_matmul padded to the GEMM's rules at (3, 36, 39), "
          f"(16, 63, 14), (17, 90, 117), (1000, 36, 64): exact")
    return sums


def int8_launches() -> dict:
    """launches() with the int8 GEMMs since the last reset_int8()."""
    from seld_tpu_torch.quant import int8_matmul

    return {**launches(), "int8_mm": int8_matmul.launches}


def reset_int8() -> None:
    from seld_tpu_torch.quant import int8_matmul

    reset_launches()
    int8_matmul.launches = 0


def int8_predicts(dev, path: Path, wave, tag: str) -> dict:
    """The clip predicted bf16, int8 and weight-only (each calibrated on the
    clip): one counted predict each (K1 / K4 once, K3 forward 4 a forward
    at T >= 512, int8 GEMMs one a quantized layer a forward), then five
    timed each, in turns, and one profiled each; the agreement with the
    bf16 grid."""
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.quant import eligible_names

    preds = {"bf16": SELDPredictor(path, batch_windows=8, device=dev)}
    preds["int8"] = SELDPredictor(path, batch_windows=8, device=dev).quantize(calib_waves=[wave])
    preds["weight-only"] = SELDPredictor(path, batch_windows=8, device=dev).quantize(
        calib_waves=[wave], weight_only=True)
    p = preds["bf16"]
    key = "k1" if p.cfg.features.feature_set == "mel" else "k4"
    n_windows = -(-(1 + CLIP_SECONDS * p.cfg.features.sample_rate // p.cfg.features.hop_length)
                  // p.win)
    forwards = -(-n_windows // 8)
    layers = len(eligible_names(p.cfg.model))
    found, grids = {}, {}
    for mode, pred in preds.items():
        pred.predict_waveform(wave)
        reset_int8()
        grids[mode] = pred.predict_waveform(wave).classes
        counts = int8_launches()
        want = {**only(**{key: 1, "k3_fwd": 4 * forwards if p.win >= 512 else 0}),
                "int8_mm": layers * forwards if mode == "int8" else 0}
        if counts != want:
            raise AssertionError(f"{tag} {mode} predict: launches {counts}, want {want}")
        found[mode] = counts
    times = {}
    for mode in (*preds, "bf16"):
        ms, each, peak = timed_predict(lambda pred=preds[mode]: pred.predict_waveform(wave))
        times.setdefault(mode, []).append((ms, each, peak))
    for mode, runs in times.items():
        agree = float((grids[mode] == grids["bf16"]).mean())
        medians = " / ".join(f"{ms:.2f} ms (of {', '.join(f'{x:.1f}' for x in each)})"
                             for ms, each, _ in runs)
        print(f"{tag} {mode} predict of the {CLIP_SECONDS} s clip ({n_windows} windows, "
              f"{forwards} forwards): median {medians}; peak "
              f"{max(pk for _, _, pk in runs):.2f} GiB; {agree:.4%} of cells equal to bf16; "
              f"launches {found[mode]}")
        found[f"{mode} ms"] = [ms for ms, _, _ in runs]
    for mode, pred in preds.items():
        profile_call(f"{tag.strip('[]')} {mode} predict",
                     lambda pred=pred: pred.predict_waveform(wave), found[f"{mode} ms"][0])
    found["int8 / bf16"] = found["int8 ms"][0] / found["bf16 ms"][0]
    found["weight-only / bf16"] = found["weight-only ms"][0] / found["bf16 ms"][0]
    print(f"{tag} int8 / bf16 {found['int8 / bf16']:.2f}x, weight-only / bf16 "
          f"{found['weight-only / bf16']:.2f}x (the first bf16 run's median)")
    return found, preds


def cli_serve_int8(dev, path: Path, calib_wav: Path, wave) -> dict:
    """`cli serve --int8-calib-wavs` in a thread of this process: one stream
    of the clip in 1 s chunks equal to the offline int8 predict of a
    predictor calibrated on the same WAV."""
    import threading

    from seld_tpu_torch import cli
    from seld_tpu_torch.data.audio import load_wav
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.serve import stream_client

    rc = {}
    thread = threading.Thread(target=lambda: rc.setdefault("rc", cli.main([
        "serve", "--checkpoint", str(path), "--port", "0", "--max-streams", "1",
        "--int8-calib-wavs", str(calib_wav)])))
    log = logging.getLogger("seld_tpu_torch")
    level = log.level
    log.setLevel(logging.INFO)
    try:
        with log_messages("seld_tpu_torch") as messages:
            t0 = time.perf_counter()
            thread.start()
            port = None
            while port is None and thread.is_alive() and time.perf_counter() - t0 < 300:
                found = [re.search(r"Serving \S+ on 127\.0\.0\.1:(\d+) \(int8", m)
                         for m in list(messages)]
                port = next((int(m.group(1)) for m in found if m), None)
                time.sleep(0.05)
        if port is None:
            raise AssertionError("cli serve --int8-calib-wavs printed no int8 Serving line")
        ready_s = time.perf_counter() - t0
        reset_int8()
        t1 = time.perf_counter()
        classes = stream_client("127.0.0.1", port, chunked(wave, None, 24_000), timeout=300)[0]
        wall_ms = (time.perf_counter() - t1) * 1e3
        counts = int8_launches()
        thread.join(timeout=120)
    finally:
        log.setLevel(level)
    offline = SELDPredictor(path, batch_windows=8, device=dev).quantize(
        calib_waves=[load_wav(calib_wav)[0]]).predict_waveform(wave).classes
    if thread.is_alive() or rc.get("rc") != 0 or not np.array_equal(classes, offline):
        raise AssertionError(f"cli serve --int8-calib-wavs: rc {rc}, the stream "
                             f"{'equals' if np.array_equal(classes, offline) else 'differs from'}"
                             " the offline int8 predict")
    print(f"[int8] cli serve --int8-calib-wavs (ready in {ready_s:.1f} s): one stream of the "
          f"{CLIP_SECONDS} s clip in 1 s chunks equal to the offline int8 predict, {wall_ms:.1f} "
          f"ms; launches {counts}")
    return counts


def phase_int8(dev: torch.device) -> tuple[dict, dict]:
    """Phase 17: int8 and QAT on the full-width flagship (see the module's
    docstring). Returns ({path: launches} of the int8 paths, of the QAT
    paths)."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.data.audio import load_wav, write_wav
    from seld_tpu_torch.export import export_serving
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.ops.loss_cuda import grid_loss_terms
    from seld_tpu_torch.ops.mel_cuda import log_mel_frames
    from seld_tpu_torch.quant import eligible_names

    t_phase = time.perf_counter()
    steps, int8, qat = {}, {}, {}
    sr = Config().features.sample_rate
    wave = clip_waves(1)[0]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        short = seeded_checkpoint(root / "mel_250.pt", [], dev)
        long = seeded_checkpoint(root / "mel_iv_1000.pt", INT8_T1000, dev)
        found, preds = int8_predicts(dev, short, wave, "[int8 mel T = 250]")
        layers = len(eligible_names(preds["bf16"].cfg.model))  # the flagship's 96
        int8["predict mel T = 250"] = found["int8"]
        sums = check_int_mm(dev, int_mm_calls(lambda: preds["int8"].predict_waveform(wave)))
        steps["T = 250 predicts and GEMMs"] = time.perf_counter() - t_phase
        p8 = preds["int8"]
        offline = p8.predict_waveform(wave).classes
        streamed, blocks, counts = stream_once(p8, chunked(wave, None, sr), 0.0)
        if not np.array_equal(streamed, offline) or counts["k1"] != blocks:
            raise AssertionError(f"[int8] the int8 stream differs from offline or K1 {counts} != "
                                 f"{blocks} frame blocks")
        int8["stream mel T = 250"] = counts
        print(f"[int8] the int8 stream of the {CLIP_SECONDS} s clip in 1 s chunks: equal to the "
              f"offline int8 predict; K1 {counts['k1']} launches = {blocks} frame blocks")
        found_long, long_preds = int8_predicts(dev, long, wave, "[int8 mel_iv T = 1000]")
        int8["predict mel_iv T = 1000"] = found_long["int8"]
        del preds, long_preds
        steps["T = 1000 predicts"] = time.perf_counter() - t_phase - sum(steps.values())
        iv = seeded_checkpoint(root / "mel_iv_250.pt", ["features.feature_set=mel_iv"], dev)
        first = SELDPredictor(iv, batch_windows=8, device=dev).quantize(calib_waves=[wave])
        first.tta(INT8_TTA)
        then = SELDPredictor(iv, batch_windows=8, device=dev).tta(INT8_TTA)
        then.quantize(calib_waves=[wave])
        reset_int8()
        got = first.predict_waveform(wave).classes
        counts = int8_launches()
        n_windows = -(-(1 + CLIP_SECONDS * sr // first.cfg.features.hop_length) // first.win)
        forwards = len(INT8_TTA) * -(-n_windows // 8)
        want = {**only(k4=1), "int8_mm": layers * forwards}
        if counts != want or not np.array_equal(got, then.predict_waveform(wave).classes):
            raise AssertionError(f"[int8] TTA + int8: launches {counts}, want {want}, or the "
                                 "orders differ")
        int8["tta mel_iv T = 250"] = counts
        print(f"[int8] int8 under TTA ({len(INT8_TTA)} views), mel_iv T = 250: the grid is the "
              f"same whichever of tta() and quantize() came first; launches {counts} "
              f"({forwards} forwards)")
        del first, then
        calib_wav = root / "clip.wav"
        write_wav(calib_wav, wave, sr)
        calib = [load_wav(calib_wav)[0]]
        for weight_only in (False, True):
            mode = "weight-only" if weight_only else "int8"
            art = root / f"{mode}.pt2"
            t0 = time.perf_counter()
            export_serving(short, art, batch_windows=8, device=dev, int8_calib_waves=calib,
                           int8_weight_only=weight_only)
            export_s = time.perf_counter() - t0
            served = SELDPredictor.from_artifact(art, device=dev)
            live = SELDPredictor(short, batch_windows=8, device=dev).quantize(
                calib_waves=calib, weight_only=weight_only)
            reset_int8()
            got = served.predict_waveform(wave).classes
            counts = int8_launches()
            if (not served.quantized or served.int8_weight_only != weight_only
                    or not np.array_equal(got, live.predict_waveform(wave).classes)):
                raise AssertionError(f"[int8] the {mode} artifact's grid differs from the "
                                     "predictor's")
            with open(art, "rb") as f:
                graph = torch.export.load(f).graph
            gemms = sum("_int_mm" in str(n.target) for n in graph.nodes)
            if gemms != (0 if weight_only else layers):
                raise AssertionError(f"[int8] the {mode} program holds {gemms} _int_mm nodes")
            int8[f"artifact {mode}"] = counts
            print(f"[int8] {mode} artifact of the mel T = 250 flagship (export "
                  f"--int8-calib-wavs{' --int8-weight-only' if weight_only else ''}): exported "
                  f"in {export_s:.1f} s, {art.stat().st_size / 1e6:.1f} MB + "
                  f"{Path(f'{art}.probs').stat().st_size / 1e6:.1f} MB on disk, {gemms} "
                  f"aten._int_mm nodes in a program; its {CLIP_SECONDS} s predict equal to the "
                  f"predictor's {mode} grid; launches {counts}")
            del served, live
        steps["stream, TTA, artifacts"] = time.perf_counter() - t_phase - sum(steps.values())
        int8["cli serve"] = cli_serve_int8(dev, short, calib_wav, load_wav(calib_wav)[0])

        cfg = Config()
        hop = cfg.window.hop_frames(cfg.features)
        fps = sr // cfg.features.hop_length
        train_steps = -(-(2 * 30 * fps // hop) // cfg.train.batch_size)
        eval_steps = -(-(20 * fps // hop) // cfg.train.batch_size)
        run = root / "qat"
        grid_loss_terms.fwd_launches = grid_loss_terms.bwd_launches = 0
        log_mel_frames.launches = 0
        t0 = time.perf_counter()
        if cli.main(["train", "--synthetic", f"data.base_path={run}", "train.qat=true",
                     "train.num_epochs=1", "train.save_every_n_epochs=1"]) != 0:
            raise AssertionError("cli train train.qat=true failed")
        torch.cuda.synchronize()
        counts = {"k2_fwd": grid_loss_terms.fwd_launches,
                  "k2_bwd": grid_loss_terms.bwd_launches, "k1": log_mel_frames.launches}
        want = {"k2_fwd": train_steps + eval_steps, "k2_bwd": train_steps, "k1": 3}
        (record,) = [json.loads(x) for x in
                     (run / "checkpoints" / "metrics.jsonl").read_text().splitlines()]
        if counts != want or not math.isfinite(record["train"]["loss"]):
            raise AssertionError(f"cli train train.qat=true: launches {counts}, want {want}; "
                                 f"{record}")
        qat["cli train T = 250"] = counts
        print(f"[qat] cli train --synthetic train.qat=true, 1 epoch of {train_steps} train + "
              f"{eval_steps} eval steps in {time.perf_counter() - t0:.1f} s: K2 forward "
              f"{counts['k2_fwd']}, backward {counts['k2_bwd']}, K1 {counts['k1']}; train loss "
              f"{record['train']['loss']:.6f}, test {record['test']['loss']:.6f}")
        for flags in (["--int8"], ["--int8", "--int8-weight-only"]):
            reset_int8()
            report = cli_json(["eval", "--synthetic", f"data.base_path={run}", *flags,
                               "--num-visualizations", "0"])
            counts = int8_launches()
            # the corpora of --synthetic: three clips; the calibration forwards are float
            want = {**only(k1=3, k2_fwd=eval_steps),
                    "int8_mm": 0 if len(flags) > 1 else layers * eval_steps}
            if counts != want or not report["quantized_int8"]:
                raise AssertionError(f"cli eval {' '.join(flags)}: launches {counts}, want {want}")
            int8[f"cli eval {' '.join(flags)}"] = counts
            print(f"[int8] cli eval {' '.join(flags)} of the QAT run: test loss "
                  f"{report['test_loss']:.6f}, SELD_error {report['dcase2022']['SELD_error']:.4f}; "
                  f"launches {counts} (the calibration forwards are float)")
        steps["cli serve, train, eval"] = time.perf_counter() - t_phase - sum(steps.values())
    long_cfg = parse_overrides(Config(), [f"window.window_seconds={LONG_WINDOW_SECONDS}"])
    timed = {}
    for name, on in (("plain", False), ("QAT", True)):
        timed[name] = time_train_steps(dev, long_cfg, tag=f"[qat][{name} T = 1000]", qat=on)
        want = {"k3_fwd": 4, "k3_dq": 4, "k3_dkv": 4}
        if timed[name]["k3"] != want or timed[name]["k2"] != {"k2_fwd": 1, "k2_bwd": 1}:
            raise AssertionError(f"{name} step at T = 1000: launches {timed[name]}")
    qat["train step T = 1000"] = {**timed["QAT"]["k3"], **timed["QAT"]["k2"]}
    print(f"[qat] T = 1000 train step: QAT {timed['QAT']['step_ms']:.2f} ms against plain "
          f"{timed['plain']['step_ms']:.2f} ms ({timed['QAT']['step_ms'] / timed['plain']['step_ms']:.2f}x); "
          f"peak {timed['QAT']['peak_gib']:.2f} / {timed['plain']['peak_gib']:.2f} GiB")
    steps["T = 1000 steps"] = time.perf_counter() - t_phase - sum(steps.values())
    print(f"[int8] phase 17 took {time.perf_counter() - t_phase:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in steps.items())}); GEMM ms a T = 250 "
          f"forward {json.dumps(sums)}")
    return int8, qat


KD_OPS_PER_ELEMENT = 16  # the grid KD's forward: two scaled log-softmaxes, exp, sub, mul, sum
KD_BWD_OPS_PER_ELEMENT = 8  # its gradient w.r.t. the student: softmax - teacher, scaled


def kd_loss_timing(dev, teacher, student, mel, kd, temperature: float) -> dict:
    """The grid KD loss alone at the main path's shape: the student's and
    teacher's logits of one batch, the forward and the forward + backward
    (w.r.t. the student's logits) timed with the launches queued ahead,
    against the larger of their bytes over HBM (each input read once, the
    gradient written once) and their float32 operations."""
    with torch.no_grad():
        s_out, t_out = student(mel), teacher(mel)
    s = s_out.detach().requires_grad_()
    em = torch.ones(mel.shape[0], device=dev)
    n = s.numel()

    def forward():
        return kd(s, t_out, em, temperature=temperature)

    def both():
        forward().backward()

    rows = {}
    for what, fn, nbytes, ops in (
            ("forward", forward, s.nbytes + t_out.nbytes, KD_OPS_PER_ELEMENT * n),
            ("forward + backward", both, 2 * s.nbytes + t_out.nbytes,
             (KD_OPS_PER_ELEMENT + KD_BWD_OPS_PER_ELEMENT) * n)):
        ms = kernel_ms(fn, host_us(fn, calls=50))
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        bound = max(by_bytes, by_ops)
        rows[what] = {"ms": ms, "bound_ms": bound,
                      "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
        print(f"[distill] grid KD loss {what} at {tuple(s.shape)} ({s.dtype} student, "
              f"{t_out.dtype} teacher logits): {ms:.4f} ms; bound {bound:.4f} ms by "
              f"{rows[what]['bound_by']} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP) = "
              f"{bound / ms:.1%} of it")
    return rows


def mel_t(cfg) -> int:
    return cfg.window.window_frames(cfg.features)


def phase_distill(dev: torch.device, flagship_run: Path) -> dict:
    """Phase 18: knowledge distillation (seld_tpu_torch/distill.py) with phase
    6's trained flagship as the teacher. Returns {path: launches}."""
    from seld_tpu_torch import cli
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.distill import load_teacher
    from seld_tpu_torch.losses import SELDLossFn
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.optimizer import make_optimizer
    from seld_tpu_torch.train.state import create_train_state
    from seld_tpu_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    found, steps = {}, {}
    teacher_dir = flagship_run / "checkpoints"
    crnn = ["model.model_type=crnn"]
    cfg = parse_overrides(Config(), crnn)
    hop = cfg.window.hop_frames(cfg.features)
    fps = cfg.features.sample_rate // cfg.features.hop_length
    train_steps = -(-(2 * 30 * fps // hop) // cfg.train.batch_size)
    eval_steps = -(-(20 * fps // hop) // cfg.train.batch_size)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        log = logging.getLogger("seld_tpu_torch")
        level = log.level
        log.setLevel(logging.INFO)
        reset_launches()
        t0 = time.perf_counter()
        try:
            with log_messages("seld_tpu_torch") as messages:
                rc = cli.main(["train", "--synthetic", f"data.base_path={root / 'crnn'}", *crnn,
                               f"train.distill_ckpt={teacher_dir}", "train.num_epochs=1",
                               "train.save_every_n_epochs=1"])
        finally:
            log.setLevel(level)
        wall_s = time.perf_counter() - t0
        counts = launches()
        lines = [m for m in messages if m.startswith("Distillation: teacher")]
        (record,) = [json.loads(x) for x in
                     (root / "crnn" / "checkpoints" / "metrics.jsonl").read_text().splitlines()]
        want = only(k1=3, k2_fwd=train_steps + eval_steps, k2_bwd=train_steps)
        if (rc != 0 or counts != want or len(lines) != 1
                or not lines[0].startswith("Distillation: teacher resnet_conformer (epoch ")
                or "-> student crnn; alpha=0.5 temperature=2" not in lines[0]
                or not all(math.isfinite(record["train"][k]) for k in ("loss", "kd", "hard"))):
            raise AssertionError(f"cli train with train.distill_ckpt: rc {rc}, launches {counts}, "
                                 f"want {want}; log {lines}; {record}")
        found["cli train flagship -> crnn T = 250"] = counts
        print(f"[distill] cli train --synthetic model.model_type=crnn train.distill_ckpt=<phase "
              f"6's run>, 1 epoch of {train_steps} train + {eval_steps} eval steps in "
              f"{wall_s:.1f} s: '{lines[0]}'; train loss {record['train']['loss']:.6f} = 0.5 "
              f"hard {record['train']['hard']:.6f} + 0.5 kd {record['train']['kd']:.6f}, test "
              f"{record['test']['loss']:.6f}; launches {counts}")
        steps["cli train"] = time.perf_counter() - t_phase

        spec, _ = load_teacher(cfg, teacher_dir, dev)
        timed = {}
        for name, distill in (("plain", None), ("distilled", spec)):
            timed[name] = time_train_steps(dev, cfg, tag=f"[distill][{name} crnn T = 250]",
                                           distill=distill)
            if timed[name]["k2"] != {"k2_fwd": 1, "k2_bwd": 1} or any(timed[name]["k3"].values()):
                raise AssertionError(f"{name} CRNN step: launches {timed[name]}")
        found["step flagship -> crnn T = 250"] = {**timed["distilled"]["k2"],
                                                  **timed["distilled"]["k3"]}
        plain, dist = timed["plain"], timed["distilled"]
        print(f"[distill] CRNN train step at T = {mel_t(cfg)}, batch {cfg.train.batch_size}: "
              f"distilled "
              f"{dist['step_ms']:.2f} ms against plain {plain['step_ms']:.2f} ms (+"
              f"{dist['step_ms'] - plain['step_ms']:.2f} ms, {dist['step_ms'] / plain['step_ms']:.2f}x);"
              f" peak {dist['peak_gib']:.2f} against {plain['peak_gib']:.2f} GiB (+"
              f"{dist['peak_gib'] - plain['peak_gib']:.2f} GiB)")
        gen = torch.Generator(device=dev).manual_seed(18)
        mel = torch.randn((cfg.train.batch_size, mel_t(cfg), 4, cfg.model.n_mels), device=dev,
                          generator=gen)
        with torch.no_grad():
            teacher_ms = cuda_ms(lambda: spec.teacher(mel), iters=10)
            profile_call("distill teacher forward T = 250", lambda: spec.teacher(mel), teacher_ms)
        print(f"[distill] the flagship teacher's eval forward alone at batch "
              f"{cfg.train.batch_size}, T = {mel_t(cfg)}: {teacher_ms:.2f} ms")
        student = build_model(cfg.model, cfg.grid, device=dev, seed=0)
        kd_rows = kd_loss_timing(dev, spec.teacher, student, mel, spec.kd, spec.temperature)
        del student
        steps["T = 250 steps"] = time.perf_counter() - t_phase - sum(steps.values())

        # QAT on the student: the teacher's output inside the step is its
        # plain eval forward on the same batch
        model = build_model(cfg.model, cfg.grid, device=dev, seed=0)
        optimizer = make_optimizer(model.parameters(), 1e-3, 1e-4)
        step = make_train_step(model, SELDLossFn(cfg.loss, cfg.grid), optimizer, cfg.grid.num_classes,
                               qat=True, distill=spec)
        mask = torch.randint(0, 2 ** 13, (*mel.shape[:2], cfg.grid.n_cells), device=dev,
                             generator=gen).to(torch.int16)
        seen = []
        hook = spec.teacher.register_forward_hook(lambda m, i, out: seen.append(out))
        reset_launches()
        try:
            _, metrics = step(create_train_state(model, optimizer), mel, mask, None, (0, 1))
        finally:
            hook.remove()
        counts = launches()
        with torch.no_grad():
            want_out = spec.teacher(mel)
        if (len(seen) != 1 or not torch.equal(seen[0], want_out)
                or counts != only(k2_fwd=1, k2_bwd=1)
                or not all(torch.isfinite(v) for v in metrics.values())):
            raise AssertionError(f"QAT + distill step: teacher outputs {len(seen)}, launches "
                                 f"{counts}, metrics {metrics}")
        found["QAT step flagship -> crnn T = 250"] = counts
        print(f"[distill] QAT + distill CRNN step: the teacher's output inside the step is its "
              f"eval forward bit for bit; kd {metrics['kd'].item():.6f}, hard "
              f"{metrics['hard'].item():.6f}; launches {counts}")
        del model, optimizer, step, seen, want_out, spec

        # T = 1000: a seeded flagship teacher distills a default Conformer
        long = [f"window.window_seconds={LONG_WINDOW_SECONDS}"]
        seeded_checkpoint(root / "t1000" / "best" / "epoch_0000.pt", long, dev, seed=1)
        lcfg = parse_overrides(Config(), ["model.model_type=conformer", *long])
        lspec, _ = load_teacher(lcfg, root / "t1000", dev)
        r = time_train_steps(dev, lcfg, tag="[distill][flagship -> conformer T = 1000]",
                             distill=lspec)
        n_s, n_t = lcfg.model.conf_n_layers, Config().model.resnet_conf_n_layers
        want = {"k3_fwd": n_t + n_s, "k3_dq": n_s, "k3_dkv": n_s}
        if r["k3"] != want or r["k2"] != {"k2_fwd": 1, "k2_bwd": 1}:
            raise AssertionError(f"distilled Conformer step at T = 1000: launches {r}, want "
                                 f"K3 {want}")
        found["step flagship -> conformer T = 1000"] = {**r["k2"], **r["k3"]}
        del lspec
        steps["T = 1000 step"] = time.perf_counter() - t_phase - sum(steps.values())

        # multi-ACCDOA under both track matchings
        multi = ACCDOA_FAMILIES[1][1]
        seeded_checkpoint(root / "multi" / "best" / "epoch_0000.pt", multi, dev, seed=1)
        kd_first = {}
        for matching in ("permutation", "position"):
            mcfg = parse_overrides(Config(), [*multi, f"train.distill_track_matching={matching}"])
            mspec, _ = load_teacher(mcfg, root / "multi", dev)
            r = time_train_steps(dev, mcfg, tag=f"[distill][multi-ACCDOA {matching}]",
                                 distill=mspec, profile=False)
            if (r["k2"] != {"k2_fwd": 0, "k2_bwd": 0} or any(r["k3"].values())
                    or not math.isfinite(r["first"]["kd"])):
                raise AssertionError(f"multi-ACCDOA distill ({matching}): {r}")
            found[f"step multi-ACCDOA {matching} T = 250"] = {**r["k2"], **r["k3"]}
            kd_first[matching] = r["first"]["kd"]
        if not kd_first["permutation"] <= kd_first["position"]:
            raise AssertionError(f"permutation-invariant KD above the slot-wise one: {kd_first}")
        print(f"[distill] multi_accdoa_conformer under a seeded multi_accdoa_conformer teacher: "
              f"first-step KD {kd_first['permutation']:.6f} permutation-invariant <= "
              f"{kd_first['position']:.6f} slot-wise; K2 never")
        steps["multi-ACCDOA steps"] = time.perf_counter() - t_phase - sum(steps.values())
    found["timings"] = {"plain_ms": plain["step_ms"], "distilled_ms": dist["step_ms"],
                        "plain_peak_gib": plain["peak_gib"], "distilled_peak_gib": dist["peak_gib"],
                        "teacher_forward_ms": teacher_ms, "kd": kd_rows}
    print(f"[distill] phase 18 took {time.perf_counter() - t_phase:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in steps.items())})")
    return found


# phase -> the phases whose results it takes (main runs a selection's
# dependencies too; 1 and 2, the device and the build, always run)
PHASE_NEEDS = {13: {7}, 14: {6}, 18: {6}}


def selected_phases(argv: list[str]) -> set[int]:
    """--phases 1,7,...: those phases and what they need; every phase
    without the option."""
    every = set(range(1, 19))
    if not argv:
        return every
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: chip_smoke.py [--phases N,M,...]")
    chosen = {int(x) for x in argv[1].split(",") if x.strip()} | {1, 2}
    if not chosen <= every:
        raise SystemExit(f"no phase {sorted(chosen - every)}; phases are 1-18")
    for n in sorted(chosen, reverse=True):
        chosen |= PHASE_NEEDS.get(n, set())
    return chosen


def quiesce() -> None:
    """Before the last lines: join what is left of the threads (a daemon's
    workers; a sampler's stager blocked on its queue never logs, so the
    wait is bounded) and take the package's log handlers off standard
    output, so that no log line can follow the contract's last line."""
    import threading

    from seld_tpu_torch.utils.logging import close_logging

    deadline = time.perf_counter() + 10.0
    for t in threading.enumerate():
        if t is not threading.main_thread() and t.is_alive():
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
    close_logging()
    sys.stdout.flush()


def main(argv: list[str]) -> int:
    t_start = time.perf_counter()
    phases = selected_phases(argv)
    name, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    rows = {}  # the kernels line's rows, from phase 3
    if 3 in phases or 12 in phases:
        with no_tf32():  # the plain versions in true float32
            if 3 in phases:
                rows["k1"] = phase_k1(dev)
                rows["k2_fwd"], rows["k2_bwd"] = phase_k2(dev)
                rows["k3"] = phase_k3(dev)
                rows["k4"] = phase_k4(dev)
            k5_kernel_ms = phase_k5_profile(dev)  # phase 12's, right after phase 3
    k1, k2_fwd, k2_bwd = (rows.get(k, {}) for k in ("k1", "k2_fwd", "k2_bwd"))
    k3_rows, k4_rows = rows.get("k3", [{}, {}, {}]), rows.get("k4", [{}, {}])
    if 4 in phases:
        k1["launches"], imported = phase_flagship(dev)
        k1["launches_import"] = {"cli predict, float32 WAV": 1,
                                 "cli predict, EXTENSIBLE float32 WAV": 1}
        print(f"[import] {json.dumps(imported)}")
    if 5 in phases:
        phase_f32(dev)
    (ROOT / "build").mkdir(exist_ok=True)
    flagship_run = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        if 6 in phases:
            counts = phase_train(dev, flagship_run)
            k2_fwd["launches"], k2_bwd["launches"] = counts["k2_fwd"], counts["k2_bwd"]
        if 7 in phases:
            counts, long_train_loss = phase_long_window(dev)
            for row, key in zip(k3_rows, ("k3_fwd", "k3_dq", "k3_dkv")):
                row["launches"] = counts[key]
            k3_rows[0]["launches_viz"] = counts["k3_fwd_viz"]
            for row, key in ((k2_fwd, "k2_fwd"), (k2_bwd, "k2_bwd"),
                             *zip(k3_rows, ("k3_fwd", "k3_dq", "k3_dkv"))):
                row["launches_traced"] = counts["trace"][key]
        k5_rows = []
        with no_tf32():
            f2_rows = phase_f2(dev) if 11 in phases else []
            if 12 in phases:
                k5_rows = phase_k5(dev)
        for row in k5_rows:
            row["profiled_kernel_ms"] = k5_kernel_ms[row["name"].split()[1]]
        if 13 in phases:
            counts = phase_sequence_parallel(dev, long_train_loss)
            if k5_rows:
                k5_rows[0]["launches"] = counts["k5_fwd"]
                k5_rows[1]["launches"] = counts["k5_dq"] + counts["k5_dkv"]
                for row, by in zip(k5_rows, ({"K3 fwd": counts["k5_fwd"]},
                                             {"K3 dQ": counts["k5_dq"],
                                              "K3 dK/dV": counts["k5_dkv"]})):
                    row["launches_in"] = ("the sharded cli train epoch at T = 1000, 1-rank "
                                          "NCCL ring (n = 1)")
                    row["launches_by_kernel"] = by
        if 8 in phases:
            counts = phase_spatial(dev)
            for row, key in zip(k4_rows, ("mel_iv", "mel_gcc")):
                row["launches"] = counts[key]
        if 9 in phases:
            print(f"[paths] launches by path: {json.dumps(phase_backbones(dev))}")
        if 10 in phases:
            print(f"[paths] K3 launches a T = 1000 flagship step by option: "
                  f"{json.dumps(phase_flagship_options(dev))}")
        if 14 in phases:
            found = phase_accdoa(dev, flagship_run)
            print(f"[paths] launches on the ACCDOA and calibration paths: {json.dumps(found)}")
            for row, key in ((k1, "k1"), (k2_fwd, "k2_fwd"), (k2_bwd, "k2_bwd"),
                             *zip(k3_rows, ("k3_fwd", "k3_dq", "k3_dkv")), (k4_rows[0], "k4")):
                row["launches_accdoa"] = accdoa_launches(found, key)
        if 18 in phases:
            distilled = phase_distill(dev, flagship_run)
            timings = distilled.pop("timings")
            print(f"[paths] launches on the distillation paths: {json.dumps(distilled)}")
            print(f"[distill] timings {json.dumps(timings)}")
            for row, key in ((k1, "k1"), (k2_fwd, "k2_fwd"), (k2_bwd, "k2_bwd"),
                             *zip(k3_rows, ("k3_fwd", "k3_dq", "k3_dkv"))):
                row["launches_distill"] = {p: c[key] for p, c in distilled.items() if key in c}
    finally:
        shutil.rmtree(flagship_run, ignore_errors=True)
    if 15 in phases:
        served = phase_serving(dev)
        print(f"[paths] launches on the serving paths: {json.dumps(served)}")
        for row, key in ((k1, "k1"), (k2_fwd, "k2_fwd"), (k3_rows[0], "k3_fwd"),
                         (k4_rows[0], "k4")):
            row["launches_stream"] = {p: c[key] for p, c in served.items()
                                      if "stream" in p and key in c}
            row["launches_tta"] = {p: c[key] for p, c in served.items()
                                   if "stream" not in p and key in c and "tta" in p.lower()}
    if 16 in phases:
        daemon = phase_daemon(dev)
        print(f"[paths] launches on the daemon and artifact paths: "
              f"{json.dumps({k: v['launches'] for k, v in daemon.items() if 'launches' in v})}")
        for row, key in ((k1, "k1"), (k3_rows[0], "k3_fwd"), (k4_rows[0], "k4")):
            row["launches_served"] = {p[len("serve "):]: c["launches"][key]
                                      for p, c in daemon.items() if p.startswith("serve ")}
            row["launches_artifact"] = {p: c["launches"][key] for p, c in daemon.items()
                                        if "artifact_ms" in c}
        k3_rows[0]["host_us_operator"] = daemon["k3 host us"]["operator"]
    if 17 in phases:
        int8, qat = phase_int8(dev)
        print(f"[paths] launches on the int8 and QAT paths: "
              f"{json.dumps({'int8': int8, 'qat': qat})}")
        for row, key in ((k1, "k1"), (k2_fwd, "k2_fwd"), (k2_bwd, "k2_bwd"),
                         *zip(k3_rows, ("k3_fwd", "k3_dq", "k3_dkv")), (k4_rows[0], "k4")):
            row["launches_int8"] = {p: c[key] for p, c in int8.items() if key in c}
            row["launches_qat"] = {p: c[key] for p, c in qat.items() if key in c}
    quiesce()
    print(f"[time] phases {','.join(map(str, sorted(phases)))}: "
          f"{time.perf_counter() - t_start:.1f} s in all, the build included")
    if 3 in phases:  # the kernels line needs phase 3's rows
        print(json.dumps({"kernels": [k1, k2_fwd, k2_bwd, *k3_rows, *k4_rows, *f2_rows,
                                      *k5_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sp-worker"]:
        sys.exit(sp_worker(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
