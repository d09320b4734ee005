"""Decoded-grid post-processing: temporal majority smoothing (counterpart:
seld_tpu/postprocess.py, the same host-side numpy code).

`smooth_classes` is the categorical analogue of a median filter: each
(frame, cell)'s class becomes the MAJORITY class over a centered
temporal window of `width` frames (shrunk at clip edges), with the tie
broken toward the frame's ORIGINAL class (so the filter is idempotent
on already-smooth regions and width=1 is the identity). Vectorized as
one cumulative-sum pass per class — O(M·T·G) with no Python loops over
frames/cells. It applies to complete decoded grids only, after bg_bias
has shaped the per-frame decode.
"""

from __future__ import annotations

import numpy as np


def validate_width(width: int) -> int:
    width = int(width)
    if width < 0:
        raise ValueError(f"median_filter width must be >= 0, got {width}")
    if width and width % 2 == 0:
        raise ValueError(
            f"median_filter width must be odd (centered window), got {width}"
        )
    return width


def smooth_classes(classes: np.ndarray, width: int,
                   num_classes: int) -> np.ndarray:
    """Temporal majority filter on decoded class grids.

    classes: int array (..., T, G) of per-frame per-cell argmax classes.
    width: odd window length in frames (0 or 1 = identity).
    Returns the same shape/dtype; each frame's class is the most frequent
    class in its centered window, ties broken toward the original class.
    """
    width = validate_width(width)
    if width <= 1 or classes.size == 0:
        return classes
    t = classes.shape[-2]
    half = width // 2
    # windowed counts per class via cumulative sums along T
    lo = np.maximum(np.arange(t) - half, 0)
    hi = np.minimum(np.arange(t) + half + 1, t)
    best_count = np.zeros(classes.shape, np.int32)
    best_class = np.zeros(classes.shape, classes.dtype)
    orig_count = np.zeros(classes.shape, np.int32)
    for m in range(num_classes):
        binary = (classes == m)
        csum = np.zeros(
            (*classes.shape[:-2], t + 1, classes.shape[-1]), np.int32
        )
        np.cumsum(binary, axis=-2, out=csum[..., 1:, :])
        counts = csum[..., hi, :] - csum[..., lo, :]  # (..., T, G)
        take = counts > best_count
        best_count = np.where(take, counts, best_count)
        best_class = np.where(take, classes.dtype.type(m), best_class)
        orig_count = np.where(classes == m, counts, orig_count)
    # tie toward the original class: keep it whenever its own count
    # reaches the maximum (strict > above means a later class never
    # displaces an equal earlier one, so >= here is exact)
    keep = orig_count >= best_count
    return np.where(keep, classes, best_class)
