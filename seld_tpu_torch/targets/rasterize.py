"""Grid labels as class bitmasks (counterpart:
seld_tpu/targets/rasterize.py).

A clip's labels are a (T, G) uint16 array on the host: bit c of a cell is
set when event class c is active there, and 0 means background. The
encoder and the CSV reader are numpy; `decode_class_bitmask` runs on
tensors. On a device the masks travel as torch.int16 with the same bits
(see seld_tpu_torch.data.sampler.place_batch): only 13 bits are ever set,
and torch's shifts do not take uint16.
"""

from __future__ import annotations

import numpy as np
import torch

from seld_tpu_torch.grid import cell_index, polar_to_grid


def total_label_frames(n_samples: int, sample_rate: int, label_frame_ms: int = 20) -> int:
    """Number of label frames of a clip: int(duration_s * 1000 / label_frame_ms)."""
    return int((n_samples / sample_rate) * 1000.0 / label_frame_ms)


def encode_events_to_bitmask(
    frames: np.ndarray,
    classes: np.ndarray,
    azimuths: np.ndarray,
    elevations: np.ndarray,
    total_frames: int,
    n_el: int = 18,
    n_az: int = 36,
    fanout: int = 5,
) -> np.ndarray:
    """Metadata rows (frame at 100 ms, class, azimuth, elevation) -> a
    (total_frames, n_el * n_az) uint16 class bitmask. Each metadata frame
    covers `fanout` label frames; rows only ever add bits."""
    mask = np.zeros((total_frames, n_el * n_az), dtype=np.uint16)
    if len(frames) == 0:
        return mask
    frames = np.asarray(frames, dtype=np.int64)
    classes = np.asarray(classes, dtype=np.int64)
    i, j = polar_to_grid(azimuths, elevations, n_el, n_az)
    cells = cell_index(i.astype(np.int64), j.astype(np.int64), n_az)
    bits = (1 << classes).astype(np.uint16)
    base = frames * fanout
    for o in range(fanout):
        t = base + o
        valid = t < total_frames
        np.bitwise_or.at(mask, (t[valid], cells[valid]), bits[valid])
    return mask


def bitmask_to_dense(mask: np.ndarray, num_classes: int = 14) -> np.ndarray:
    """numpy decoder: (T, G) uint16 bitmask -> (T, G, num_classes) float32
    multi-hot labels, the last class 1 where no event bit is set."""
    event_bits = np.arange(num_classes - 1, dtype=np.uint16)
    onehot = ((mask[..., None] >> event_bits) & 1).astype(np.float32)
    background = (mask == 0).astype(np.float32)[..., None]
    return np.concatenate([onehot, background], axis=-1)


def decode_class_bitmask(mask: torch.Tensor, num_classes: int = 14,
                         class_major: bool = False) -> torch.Tensor:
    """Tensor decoder: integer mask (..., G) -> float32 (..., G, num_classes),
    or the loss layout (..., num_classes, G) with class_major=True. The mask
    is widened to int32 before it is shifted."""
    m = mask.to(torch.int32)
    event_bits = torch.arange(num_classes - 1, dtype=torch.int32, device=m.device)
    if class_major:
        onehot = ((m.unsqueeze(-2) >> event_bits[:, None]) & 1).float()
        background = (m == 0).float().unsqueeze(-2)
        return torch.cat([onehot, background], dim=-2)
    onehot = ((m.unsqueeze(-1) >> event_bits) & 1).float()
    background = (m == 0).float().unsqueeze(-1)
    return torch.cat([onehot, background], dim=-1)


def load_metadata_csv(path):
    """A STARSS22 metadata CSV (no header: frame, class, source, azimuth,
    elevation) -> (frames, classes, sources, azimuths, elevations) int64."""
    data = np.loadtxt(path, delimiter=",", dtype=np.int64, ndmin=2)
    if data.size == 0:
        z = np.zeros((0,), dtype=np.int64)
        return z, z, z, z, z
    return data[:, 0], data[:, 1], data[:, 2], data[:, 3], data[:, 4]
