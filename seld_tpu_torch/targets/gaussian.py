"""Gaussian spatial label augmentation (counterpart:
seld_tpu/targets/gaussian.py), numpy on the host.

  * each unique source, keyed by (class, source number), draws ONE fixed
    (azimuth, elevation) displacement from N(0, sigma), reused for every
    metadata row of that source;
  * the displaced centre defines a 2-sigma rectangle in angle space: a
    cell belongs to it when the wrapped azimuth distance of its centre is
    at most 2 sigma_azimuth and its elevation centre lies inside
    [max(el - 2 sigma_el, -90), min(el + 2 sigma_el, 90)];
  * every member cell gets the row's class over the row's fanned-out label
    frames, as bits of the same (T, G) uint16 bitmask that point labels
    use.

The draw of a source comes from numpy's generator seeded with
[seed, file_key, class, source], so a file's labels do not depend on row
order or on the other files: the corpus passes each file's index in its
list as file_key, as the JAX package does, and both give the same bits.
"""

from __future__ import annotations

import numpy as np

from seld_tpu_torch.grid import cell_centers, wrap_angle_diff
from seld_tpu_torch.targets.rasterize import bitmask_to_dense


def draw_source_noise(classes: np.ndarray, sources: np.ndarray, sigma_azimuth: float = 5.0,
                      sigma_elevation: float = 5.0, seed: int = 0,
                      file_key: int = 0) -> dict[tuple[int, int], tuple[float, float]]:
    """One fixed (azimuth, elevation) Gaussian displacement per unique
    (class, source), drawn in that order from
    default_rng([seed, file_key, class, source])."""
    noise = {}
    for c, s in sorted({(int(c), int(s)) for c, s in zip(classes, sources)}):
        g = np.random.default_rng(np.array([seed, file_key, c, s], dtype=np.uint64))
        az_noise = g.normal(0.0, sigma_azimuth)
        el_noise = g.normal(0.0, sigma_elevation)
        noise[(c, s)] = (float(az_noise), float(el_noise))
    return noise


def gaussian_region_mask(center_az: np.ndarray, center_el: np.ndarray, sigma_azimuth: float,
                         sigma_elevation: float, n_el: int = 18,
                         n_az: int = 36) -> np.ndarray:
    """Region membership of every cell for each row: (R, n_el * n_az) bool."""
    center_az = np.asarray(center_az, dtype=np.float64)[:, None, None]  # (R, 1, 1)
    center_el = np.asarray(center_el, dtype=np.float64)[:, None, None]
    cell_el, cell_az = cell_centers(n_el, n_az)
    az_in = np.abs(wrap_angle_diff(cell_az[None, None, :], center_az)) <= 2.0 * sigma_azimuth
    # the bounds are clipped to [-90, 90] before the range test
    el_min = np.maximum(center_el - 2.0 * sigma_elevation, -90.0)
    el_max = np.minimum(center_el + 2.0 * sigma_elevation, 90.0)
    cell_el = cell_el[None, :, None]
    el_in = (cell_el >= el_min) & (cell_el <= el_max)
    return (az_in & el_in).reshape(center_az.shape[0], n_el * n_az)


def rasterize_gaussian_labels(frames: np.ndarray, classes: np.ndarray, sources: np.ndarray,
                              azimuths: np.ndarray, elevations: np.ndarray,
                              total_frames: int, n_el: int = 18, n_az: int = 36,
                              num_classes: int = 14, fanout: int = 5,
                              sigma_azimuth: float = 5.0, sigma_elevation: float = 5.0,
                              seed: int = 0, file_key: int = 0,
                              return_dense: bool = True):
    """Gaussian-region labels as a (total_frames, G) uint16 bitmask, or
    its dense (T, num_classes, G) decode when return_dense."""
    mask = np.zeros((total_frames, n_el * n_az), dtype=np.uint16)
    frames = np.asarray(frames, dtype=np.int64)
    classes = np.asarray(classes, dtype=np.int64)
    if len(frames):
        source_noise = draw_source_noise(classes, sources, sigma_azimuth, sigma_elevation,
                                         seed, file_key)
        noise = np.array([source_noise[(int(c), int(s))] for c, s in zip(classes, sources)],
                         dtype=np.float64)  # (R, 2): azimuth, elevation
        region = gaussian_region_mask(
            np.asarray(azimuths, np.float64) + noise[:, 0],
            np.asarray(elevations, np.float64) + noise[:, 1],
            sigma_azimuth, sigma_elevation, n_el, n_az,
        )
        rows, cells = np.nonzero(region)
        bits = (1 << classes[rows]).astype(np.uint16)
        base = frames[rows] * fanout
        for o in range(fanout):
            t = base + o
            valid = t < total_frames
            np.bitwise_or.at(mask, (t[valid], cells[valid]), bits[valid])
    if return_dense:
        return bitmask_to_dense(mask, num_classes)
    return mask
