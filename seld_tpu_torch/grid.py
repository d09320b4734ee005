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
