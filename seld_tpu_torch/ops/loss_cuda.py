"""Kernel K2: the grid loss's softmax region (CUDA C++,
csrc/grid_loss_kernel.cu).

Replaces seld_tpu/ops/loss_pallas.py::grid_loss_terms. From class-major
(N, M, G) logits and an (N, G) class bitmask it computes, in one pass over
the logits, sq[n, g] = sum_m (softmax(x)[n, m, g] - t[n, m, g])^2 and the
background plane p_bg[n, g] = softmax(x)[n, M-1, g]; the backward kernel
recomputes the softmax and writes d/dlogits of both outputs in one more
pass. Unfused, the same region materialises several (N, M, G) float32
tensors each way; the kernel is bytes-bound and moves each once.

`grid_loss_terms` launches the kernels for CUDA tensors; for CPU tensors,
and only for those, it runs `grid_loss_terms_reference`, the same function
in plain PyTorch ops, differentiable by autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from seld_tpu_torch.targets.rasterize import decode_class_bitmask
from seld_tpu_torch.ops.counters import bump

MAX_CLASSES = 16  # the kernels' compile-time ceiling on M
_MASK_DTYPES = (torch.int16, torch.uint16, torch.int32, torch.int64)


def grid_loss_terms_reference(logits_mg: torch.Tensor, mask: torch.Tensor,
                              num_classes: int):
    """The plain version of K2: (N, M, G) logits, (N, G) integer bitmask ->
    (sq (N, G), p_bg (N, G)) in the logits' dtype."""
    p = torch.softmax(logits_mg, dim=1)
    t = decode_class_bitmask(mask, num_classes, class_major=True).to(p.dtype)
    return (p - t).square().sum(dim=1), p[:, -1]


def _check(logits_mg: torch.Tensor, mask: torch.Tensor, num_classes: int) -> None:
    if logits_mg.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 logits, got {logits_mg.dtype}")
    if logits_mg.dim() != 3 or logits_mg.shape[1] != num_classes:
        raise ValueError(
            f"K2 takes (N, {num_classes}, G) logits, got {tuple(logits_mg.shape)}"
        )
    if num_classes < 2 or num_classes > MAX_CLASSES:
        raise ValueError(f"K2 takes 2 to {MAX_CLASSES} classes, got {num_classes}")
    if not logits_mg.is_contiguous():
        raise ValueError("K2 takes contiguous logits")
    if mask.dtype not in _MASK_DTYPES:
        raise TypeError(
            f"K2 takes a 16-bit or wider integer bitmask (one bit per event "
            f"class), got {mask.dtype}"
        )
    if mask.shape != (logits_mg.shape[0], logits_mg.shape[2]):
        raise ValueError(
            f"K2 takes an (N, G) mask for (N, M, G) logits, got "
            f"{tuple(mask.shape)} for {tuple(logits_mg.shape)}"
        )
    if mask.device != logits_mg.device:
        raise ValueError(f"mask on {mask.device}, logits on {logits_mg.device}")
    if not mask.is_contiguous():
        raise ValueError("K2 takes a contiguous mask")


def _mask16(mask: torch.Tensor) -> torch.Tensor:
    """The mask as the 16-bit words the kernels read; at most 15 bits are
    set (M <= 16), so narrowing a wider type keeps every bit."""
    if mask.dtype == torch.int16:
        return mask
    if mask.dtype == torch.uint16:
        return mask.view(torch.int16)
    return mask.to(torch.int16)


@functools.cache
def _kernels():
    from seld_tpu_torch.ops._build import load_library

    lib = load_library("grid_loss_kernel")
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.seld_grid_loss_fwd.argtypes = [p, p, p, p, ll, i, i, p]
    lib.seld_grid_loss_bwd.argtypes = [p, p, p, p, p, ll, i, i, p]
    lib.seld_grid_loss_fwd.restype = lib.seld_grid_loss_bwd.restype = ctypes.c_int
    return lib.seld_grid_loss_fwd, lib.seld_grid_loss_bwd


class _GridLossTerms(torch.autograd.Function):
    """K2 on CUDA tensors: forward and backward are one kernel launch each,
    on the current stream of the logits' device."""

    @staticmethod
    def forward(ctx, logits_mg, mask16):
        ctx.set_materialize_grads(False)  # an unused output's cotangent stays None
        n, m, g = logits_mg.shape
        sq = torch.empty((n, g), dtype=torch.float32, device=logits_mg.device)
        pbg = torch.empty_like(sq)
        if n * g:
            with torch.cuda.device(logits_mg.device):
                stream = torch.cuda.current_stream(logits_mg.device).cuda_stream
                rc = _kernels()[0](logits_mg.data_ptr(), mask16.data_ptr(),
                                   sq.data_ptr(), pbg.data_ptr(), n, m, g, stream)
            if rc != 0:
                raise RuntimeError(f"K2 forward launch failed with CUDA error {rc}")
            bump(grid_loss_terms, "fwd_launches")
        ctx.save_for_backward(logits_mg, mask16)
        return sq, pbg

    @staticmethod
    def backward(ctx, g_sq, g_bg):
        logits_mg, mask16 = ctx.saved_tensors
        if g_sq is None and g_bg is None:
            return None, None
        n, m, g = logits_mg.shape
        # a cotangent arrives expanded (stride 0) from a sum's backward; an
        # absent one (MSE without CL never uses p_bg) goes in as a null
        # pointer, which the kernel reads as zeros
        cots = [None if c is None else c.to(torch.float32).contiguous()
                for c in (g_sq, g_bg)]
        dx = torch.empty_like(logits_mg)
        if n * g:
            # autograd's thread has no current device of its own
            with torch.cuda.device(logits_mg.device):
                stream = torch.cuda.current_stream(logits_mg.device).cuda_stream
                rc = _kernels()[1](
                    logits_mg.data_ptr(), mask16.data_ptr(),
                    *(None if c is None else c.data_ptr() for c in cots),
                    dx.data_ptr(), n, m, g, stream,
                )
            if rc != 0:
                raise RuntimeError(f"K2 backward launch failed with CUDA error {rc}")
            bump(grid_loss_terms, "bwd_launches")
        return dx, None


def grid_loss_terms(logits_mg: torch.Tensor, mask: torch.Tensor, num_classes: int):
    """(sq (N, G), p_bg (N, G)) float32 from (N, M, G) float32 contiguous
    logits and an (N, G) integer bitmask (int16 as the batches carry it;
    uint16, int32 and int64 are taken too), differentiable in the logits.

    CUDA tensors go through kernel K2 (every forward launch adds one to
    `grid_loss_terms.fwd_launches`, every backward launch one to
    `.bwd_launches`); CPU tensors go through `grid_loss_terms_reference`.
    Anything else raises."""
    _check(logits_mg, mask, num_classes)
    if logits_mg.device.type == "cpu":
        return grid_loss_terms_reference(logits_mg, mask, num_classes)
    if logits_mg.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, got {logits_mg.device}")
    return _GridLossTerms.apply(logits_mg, _mask16(mask))


grid_loss_terms.fwd_launches = 0
grid_loss_terms.bwd_launches = 0
