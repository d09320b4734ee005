"""PyTorch/CUDA port of seld_tpu for one NVIDIA H100.

The package trains, evaluates and serves the flagship ResNet50-Conformer
grid model. Serving: WAV in, log-mel features through the hand-written
CUDA kernel K1 (seld_tpu_torch/csrc/mel_kernel.cu), the eval-mode model,
and the class-argmax decode. Training: windowed corpora, the train-mode
model, the grid loss straight from class bitmasks through the
hand-written CUDA kernel K2, forward and backward
(seld_tpu_torch/csrc/grid_loss_kernel.cu), Adam with coupled L2,
checkpoints and resume. Windows of 512 frames and more run their
attention through the hand-written flash-attention kernels K3, forward,
dQ and dK/dV (seld_tpu_torch/csrc/flash_attention_kernel.cu). The spatial
feature sets "mel_iv" and "mel_gcc" run through the hand-written CUDA
kernel K4 (seld_tpu_torch/csrc/spatial_kernel.cu), with the accuracy
recipe's ACS and SpecAugment augmentations, Gaussian label targets and an
on-disk corpus cache. Training also runs over a (data, model) mesh of
processes, one GPU each (torchrun), with the window's time axis split
over the model axis and attention as the ring, K5, which runs K3's
kernels per time chunk. Evaluation:
losses, cell accuracies and the DCASE2022 metrics of a checkpoint tree on
a test corpus. Serving also streams chunked audio (stream.py), averages
the ACS scene transforms at test time (tta.py), averages rolling
checkpoints (tools/average_ckpt.py), serves many live streams over TCP
with their windows batched across streams (serve.py), and ships a model
as a torch.export artifact (export.py). int8 (quant.py): post-training
quantization of the convolutions and dense layers, their products as
int8 GEMMs (torch._int_mm, cuBLASLt on the card), weight-only int8, and
quantization-aware training (train.qat), under every serving, evaluation
and export path. It imports torch and never JAX or seld_tpu; module names
follow seld_tpu so each piece's counterpart is easy to find.

Entry points run on the card: a device of None means CUDA, and raises
when no CUDA device is visible. Pass device="cpu" to run the plain
PyTorch versions on the CPU.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["no_tf32", "resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one;
    under torchrun (LOCAL_RANK set) the process's own card, cuda:LOCAL_RANK."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; seld_tpu_torch runs on the GPU "
            "unless device='cpu' is passed"
        )
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda")


@contextlib.contextmanager
def no_tf32():
    """Run float32 convolutions and matmuls in true float32 inside the
    block (cuDNN convolutions default to TF32 on the card), and restore
    the previous process-wide setting after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
