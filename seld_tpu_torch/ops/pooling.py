"""Adaptive average pooling and bilinear resizing as matrix products
(counterpart: seld_tpu/ops/pooling.py, and the bilinear
`jax.image.resize` of seld_tpu/models/cspdarknet.py:207).

With static shapes both are fixed linear maps along each spatial axis, so
each is two products with small per-axis matrices, as the JAX package
computes them: the matrices are cast to the input's dtype and the
products run in it, so a bf16 input rounds where the reference's does.
The JAX package runs these as XLA matmuls, not as a Pallas kernel, so
torch.einsum is their counterpart here. Inputs are NCHW-like: the two
spatial axes are the last two.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 matrix M with x_out = x_in @ M: output
    index i averages inputs [floor(i * in / out), ceil((i + 1) * in / out)),
    torch's adaptive_avg_pool semantics."""
    m = np.zeros((in_size, out_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil
        m[start:end, i] = 1.0 / (end - start)
    return m


@functools.lru_cache(maxsize=32)
def bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 matrix of jax.image.resize(...,
    method="bilinear") along one axis (antialias on, its default): a
    triangle kernel at half-pixel centres, widened by in/out when
    downsampling, each column normalised to sum 1, and columns whose sample
    falls outside the input zeroed (jax._src.image.scale.compute_weight_mat,
    with scale out/in and no translation)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    weights = np.maximum(0.0, 1.0 - dist / np.float32(kernel_scale)).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0.0).astype(np.float32)


def _two_axis_product(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    mh = torch.from_numpy(mh).to(x.device, x.dtype)
    mw = torch.from_numpy(mw).to(x.device, x.dtype)
    x = torch.einsum("...hw,hi->...iw", x, mh)
    return torch.einsum("...iw,wj->...ij", x, mw)


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """x: (..., H, W) -> (..., out_h, out_w), torch adaptive_avg_pool2d
    semantics through two products."""
    h, w = x.shape[-2:]
    return _two_axis_product(x, adaptive_pool_matrix(h, out_hw[0]),
                             adaptive_pool_matrix(w, out_hw[1]))


def bilinear_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """x: (..., H, W) -> (..., out_h, out_w), jax.image.resize's bilinear
    method through two products."""
    h, w = x.shape[-2:]
    return _two_axis_product(x, bilinear_matrix(h, out_hw[0]), bilinear_matrix(w, out_hw[1]))
