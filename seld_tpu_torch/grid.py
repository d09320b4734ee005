"""Spatial-grid geometry (counterpart: seld_tpu/grid.py)."""

from __future__ import annotations

import numpy as np


def cell_centers(n_el: int, n_az: int):
    """Centre coordinates of the grid cells: (el[n_el], az[n_az]) float32
    degrees, el = -90 + (i + 0.5) * 180 / n_el and
    az = -180 + (j + 0.5) * 360 / n_az."""
    el = -90.0 + (np.arange(n_el, dtype=np.float32) + 0.5) * (180.0 / n_el)
    az = -180.0 + (np.arange(n_az, dtype=np.float32) + 0.5) * (360.0 / n_az)
    return el, az


def wrap_angle_diff(a, b):
    """Shortest signed angular distance a - b in degrees, wrapped into
    [-180, 180). Computed in float32, as the JAX package does: the
    Gaussian region test compares it at exactly 2 sigma, so float64 would
    change which cells count."""
    diff = np.asarray(a, dtype=np.float32) - np.asarray(b, dtype=np.float32)
    return (diff + 180.0) % 360.0 - 180.0


def polar_to_grid(phi, theta, n_el: int, n_az: int):
    """(azimuth, elevation) degrees -> (i, j) int32 grid indices:
    j = clip(floor((phi + 180) / 360 * n_az), 0, n_az - 1) and
    i = clip(floor((theta + 90) / 180 * n_el), 0, n_el - 1)."""
    phi = np.asarray(phi, dtype=np.float32)
    theta = np.asarray(theta, dtype=np.float32)
    j = np.clip(np.floor((phi + 180.0) / 360.0 * n_az), 0, n_az - 1).astype(np.int32)
    i = np.clip(np.floor((theta + 90.0) / 180.0 * n_el), 0, n_el - 1).astype(np.int32)
    return i, j


def cell_index(i, j, n_az: int):
    """Flatten (i, j) to the cell index i * n_az + j."""
    return i * n_az + j
