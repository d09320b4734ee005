"""ACCDOA output representation: activity-coupled Cartesian DOA
(counterpart: seld_tpu/accdoa.py).

  * The model emits one Cartesian vector per (frame, event class),
    (B, T, C, 3): its norm is the class's activity, its direction the DOA
    (Shimada et al. 2021). Multi-ACCDOA (Shimada et al. 2022) emits N = 3
    track slots per class, (B, T, N, C, 3), so that same-class sources
    that overlap can be told apart.
  * Targets come straight from the metadata rows, in numpy: unit vectors
    on active (frame, class) pairs (later rows win), or the ADPIT layout
    (T, 6, 4, C) for multi-ACCDOA (slot 0 one source, 1-2 two, 3-5
    three; channel 0 the activity, 1:4 the unit DOA).
  * The losses are masked MSE over the vectors, and ADPIT: per (frame,
    class) the least of 13 track-to-slot assignments, each candidate
    padded with the other cases' canonical ones so that inapplicable
    cases tie with the applicable one instead of winning with zeros. The
    minimum is `torch.amin`, whose gradient splits evenly among ties, as
    `jnp.min`'s does.
  * Decodes paint active classes into the az/el grid, so every grid metric
    applies unchanged. The device decodes scatter (class + 1) into the
    (..., G) cells with `scatter_reduce(..., "amax")`: the highest class
    index wins a shared cell, as in the JAX package, and no (..., C, G)
    one-hot is formed; the maximum is order-free, so a run repeats its
    bits. The host decodes are numpy, where later (higher) classes
    overwrite.

The numerics follow the JAX functions operation by operation in float32
(the norm as ((x^2 + y^2) + z^2), thresholds compared in float32), so the
decodes agree with them exactly. Names: the JAX package's `*_jnp` device
decodes are this module's torch functions without the suffix
(decode_accdoa_to_grid, decode_multi_accdoa_to_grid,
multi_accdoa_class_activity, decode_vote_grid), and its numpy decodes are
the `*_np` functions here.
"""

from __future__ import annotations

import numpy as np
import torch

from seld_tpu_torch.grid import cell_index, polar_to_grid
from seld_tpu_torch.models.conformer import ConformerTrunk
from seld_tpu_torch.models.layers import Linear

ADPIT_SLOTS = 6  # A0 | B0 B1 | C0 C1 C2
_RAD2DEG = float(np.float32(180.0 / np.pi))  # jnp.rad2deg's float32 factor
_NORM_FLOOR = float(np.float32(1e-9))


def doa_unit_vector(az_deg, el_deg) -> np.ndarray:
    """(azimuth, elevation) degrees -> unit vectors (..., 3) = (x, y, z),
    float32."""
    az = np.deg2rad(np.asarray(az_deg, dtype=np.float32))
    el = np.deg2rad(np.asarray(el_deg, dtype=np.float32))
    return np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1)


def rasterize_accdoa_targets(frames, classes, azimuths, elevations, total_frames: int,
                             num_event_classes: int = 13, fanout: int = 5) -> np.ndarray:
    """Metadata rows -> (T, num_event_classes, 3) float32 ACCDOA targets:
    the unit DOA on active (frame, class) pairs (later rows overwrite
    earlier ones), zero vectors elsewhere."""
    out = np.zeros((total_frames, num_event_classes, 3), np.float32)
    if len(frames) == 0:
        return out
    vec = doa_unit_vector(azimuths, elevations)  # (R, 3)
    base = np.asarray(frames, np.int64) * fanout
    cls = np.asarray(classes, np.int64)
    for o in range(fanout):
        t = base + o
        valid = t < total_frames
        out[t[valid], cls[valid]] = vec[valid]
    return out


def rasterize_adpit_targets(frames, classes, azimuths, elevations, total_frames: int,
                            num_event_classes: int = 13, fanout: int = 5) -> np.ndarray:
    """Metadata rows -> (T, 6, 4, C) float32 ADPIT targets. Per (metadata
    frame, class): one source fills slot 0, two fill slots 1-2, three or
    more fill slots 3-5 (a fourth and later are dropped). Channel 0 of
    axis -2 is the activity flag, channels 1:4 the unit DOA."""
    out = np.zeros((total_frames, ADPIT_SLOTS, 4, num_event_classes), np.float32)
    if len(frames) == 0:
        return out
    frames = np.asarray(frames, np.int64)
    classes = np.asarray(classes, np.int64)
    vec = doa_unit_vector(azimuths, elevations)  # (R, 3)
    # rows grouped by (frame, class): rank within the group and its size
    keys = frames * num_event_classes + classes
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    group_start = np.r_[True, keys_s[1:] != keys_s[:-1]]
    group_id = np.cumsum(group_start) - 1
    first_idx = np.nonzero(group_start)[0]
    rank = np.arange(len(keys_s)) - first_idx[group_id]
    count = np.bincount(group_id)[group_id]
    slot = np.where(count == 1, 0, np.where(count == 2, 1 + rank, 3 + rank))
    keep = slot < ADPIT_SLOTS
    f_k, c_k = frames[order][keep], classes[order][keep]
    v_k, s_k = vec[order][keep], slot[keep]
    base = f_k * fanout
    for o in range(fanout):
        t = base + o
        valid = t < total_frames
        out[t[valid], s_k[valid], 0, c_k[valid]] = 1.0
        out[t[valid], s_k[valid], 1:4, c_k[valid]] = v_k[valid]
    return out


class SELDConformerACCDOA(ConformerTrunk):
    """The Conformer trunk with an ACCDOA head: (B, T, C, F) features ->
    (B, T, num_event_classes, 3) float32 vectors, each component
    tanh-bounded; with num_tracks > 1, (B, T, num_tracks,
    num_event_classes, 3). The `accdoa` Linear runs in the compute dtype and
    tanh in float32; its outputs are ordered (track, class, axis)."""

    def __init__(self, num_event_classes: int = 13, num_tracks: int = 1,
                 cnn_channels=(64, 128, 256, 512), d_model: int = 256, n_heads: int = 4,
                 n_layers: int = 2, kernel_size: int = 31, n_channels: int = 4,
                 n_mels: int = 64, compute_dtype: torch.dtype = torch.float32,
                 dropout: float = 0.3, norm_dtype: torch.dtype = torch.float32,
                 remat: str = "none"):
        super().__init__(cnn_channels, d_model, n_heads, n_layers, kernel_size, n_channels,
                         n_mels, compute_dtype, dropout, norm_dtype, remat)
        self.num_event_classes = num_event_classes
        self.num_tracks = num_tracks
        self.accdoa = Linear(d_model, num_tracks * num_event_classes * 3,
                             compute_dtype=compute_dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.tanh(self.accdoa(x).float())
        tracks = () if self.num_tracks == 1 else (self.num_tracks,)
        return y.view(*y.shape[:2], *tracks, self.num_event_classes, 3)


def _weighted_mean(per_example: torch.Tensor, example_mask) -> torch.Tensor:
    if example_mask is None:
        return per_example.mean()
    em = example_mask.float()
    return (per_example * em).sum() / em.sum().clamp_min(1e-8)


def accdoa_loss(pred_vectors, target_vectors, example_mask=None) -> torch.Tensor:
    """Masked MSE over ACCDOA vectors, (B, T, C, 3) each; example_mask
    (B,) validity weights or None."""
    sq = (pred_vectors.float() - target_vectors).square()
    return _weighted_mean(sq.reshape(sq.shape[0], -1).mean(dim=-1), example_mask)


class ACCDOALossFn:
    """(pred, targets, example_mask) -> (total, breakdown), the calling
    convention of the grid loss, so the train and eval steps take either."""

    def __call__(self, pred_vectors, target_vectors, example_mask=None):
        loss = accdoa_loss(pred_vectors, target_vectors, example_mask)
        return loss, {"accdoa": loss}


_B_ORDERS = ((1, 1, 2), (1, 2, 1), (2, 1, 1), (1, 2, 2), (2, 1, 2), (2, 2, 1))
_C_ORDERS = ((3, 4, 5), (3, 5, 4), (4, 3, 5), (4, 5, 3), (5, 3, 4), (5, 4, 3))


def adpit_loss(pred_vectors, targets, example_mask=None) -> torch.Tensor:
    """ADPIT loss. pred_vectors (B, T, 3, C, 3): tracks, classes, axes;
    targets (B, T, 6, 4, C), the ADPIT layout. Per (frame, class) the least
    MSE over the 13 track-to-slot assignments: one for a single source
    (A0 A0 A0), six for two (orderings of B0 B0 B1 and B0 B1 B1), six for
    three (permutations of C0 C1 C2), each candidate padded with the other
    cases' canonical assignments."""
    pred = pred_vectors.float()
    targets = targets.float()
    # activity-masked DOA of each slot: (B, T, 3 axes, C)
    slot = [targets[:, :, i, 0:1, :] * targets[:, :, i, 1:4, :] for i in range(ADPIT_SLOTS)]

    def cand(x, y, z):  # (B, T, N = 3, 3 axes, C)
        return torch.stack([slot[x], slot[y], slot[z]], dim=2)

    aaa = cand(0, 0, 0)
    b_canon = cand(1, 1, 2)
    c_canon = cand(3, 4, 5)
    pad_a, pad_b, pad_c = b_canon + c_canon, aaa + c_canon, aaa + b_canon
    candidates = ([aaa + pad_a] + [cand(*p) + pad_b for p in _B_ORDERS]
                  + [cand(*p) + pad_c for p in _C_ORDERS])
    p = pred.movedim(-1, -2)  # (B, T, N, 3 axes, C)
    losses = torch.stack([(p - c).square().mean(dim=(2, 3)) for c in candidates])
    per_frame_class = losses.amin(dim=0)  # (B, T, C); ties share the gradient
    return _weighted_mean(per_frame_class.reshape(per_frame_class.shape[0], -1).mean(dim=-1),
                          example_mask)


class ADPITLossFn:
    """The calling convention of ACCDOALossFn."""

    def __call__(self, pred_vectors, targets, example_mask=None):
        loss = adpit_loss(pred_vectors, targets, example_mask)
        return loss, {"adpit": loss}


# --- device decodes --------------------------------------------------------


def _cells_and_activity(vectors: torch.Tensor, n_el: int, n_az: int, threshold: float):
    """(..., 3) vectors -> ((...) int64 cell index, (...) bool activity)."""
    v = vectors.float()
    sq = v * v
    norm = torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])
    active = norm > float(np.float32(threshold))
    az = torch.atan2(v[..., 1], v[..., 0]) * _RAD2DEG
    el = torch.asin(torch.clamp(v[..., 2] / norm.clamp_min(_NORM_FLOOR), -1.0, 1.0)) * _RAD2DEG
    j = torch.clamp(torch.floor((az + 180.0) / 360.0 * n_az), 0, n_az - 1).long()
    i = torch.clamp(torch.floor((el + 90.0) / 180.0 * n_el), 0, n_el - 1).long()
    return i * n_az + j, active


def _paint(cells: torch.Tensor, active: torch.Tensor, n_cells: int,
           num_classes: int) -> torch.Tensor:
    """(..., K, C) cells and activities -> (..., G) int8 class grid: the
    highest active class index of each cell, background where none is."""
    c = cells.shape[-1]
    label = torch.arange(1, c + 1, dtype=torch.int32, device=cells.device)
    painted = torch.where(active, label, 0).flatten(-2)  # class + 1, or 0
    lead = painted.shape[:-1]
    best = torch.zeros((*lead, n_cells), dtype=torch.int32, device=cells.device)
    best.scatter_reduce_(-1, cells.flatten(-2), painted, "amax")
    return torch.where(best > 0, best - 1, num_classes - 1).to(torch.int8)


def decode_accdoa_to_grid(vectors: torch.Tensor, n_el: int = 18, n_az: int = 36,
                          num_classes: int = 14,
                          activity_threshold: float = 0.5) -> torch.Tensor:
    """(..., C, 3) vectors -> (..., G) int8 class grid on their device:
    classes whose norm exceeds the threshold paint their decoded cell, the
    highest class index winning a shared cell; background elsewhere."""
    cells, active = _cells_and_activity(vectors, n_el, n_az, activity_threshold)
    return _paint(cells[..., None, :], active[..., None, :], n_el * n_az, num_classes)


def decode_multi_accdoa_to_grid(vectors: torch.Tensor, n_el: int = 18, n_az: int = 36,
                                num_classes: int = 14,
                                activity_threshold: float = 0.5) -> torch.Tensor:
    """(..., N, C, 3) vectors -> (..., G) int8 class grid: every active
    track paints its class, the highest class index winning a shared cell
    (decode_vote_grid of multi_accdoa_class_activity, without the
    (..., C, G) map)."""
    cells, active = _cells_and_activity(vectors, n_el, n_az, activity_threshold)
    return _paint(cells, active, n_el * n_az, num_classes)


def multi_accdoa_class_activity(vectors: torch.Tensor, n_el: int = 18, n_az: int = 36,
                                activity_threshold: float = 0.5) -> torch.Tensor:
    """(..., N, C, 3) vectors -> (..., C, G) float32 in {0, 1}: 1 where an
    active track of the class decodes into the cell. The track axis is
    reduced away, so overlapped windows can average the map."""
    cells, active = _cells_and_activity(vectors, n_el, n_az, activity_threshold)
    g = n_el * n_az
    c = cells.shape[-1]
    offsets = torch.arange(c, device=cells.device) * g
    lead = cells.shape[:-2]
    out = torch.zeros((*lead, c * g), dtype=torch.float32, device=cells.device)
    out.scatter_reduce_(-1, (cells + offsets).flatten(-2), active.float().flatten(-2), "amax")
    return out.view(*lead, c, g)


def decode_vote_grid(votes: torch.Tensor, num_classes: int = 14,
                     min_vote: float = 0.5) -> torch.Tensor:
    """(..., C, G) per-class cell votes in [0, 1] -> (..., G) int8 class
    grid: a cell is active when its best class reaches min_vote; among
    tied classes the highest index wins."""
    votes = votes.float()
    c = votes.shape[-2]
    winner = (c - 1) - torch.argmax(votes.flip(-2), dim=-2)
    best = votes.amax(dim=-2)
    return torch.where(best >= float(np.float32(min_vote)), winner,
                       num_classes - 1).to(torch.int8)


def grid_decoder(multi: bool, n_el: int = 18, n_az: int = 36, num_classes: int = 14):
    """The device decode of a family on a grid: (vectors, threshold) ->
    (..., G) int8."""
    decode = decode_multi_accdoa_to_grid if multi else decode_accdoa_to_grid
    return lambda vectors, threshold: decode(vectors, n_el, n_az, num_classes, threshold)


# --- host decodes (numpy) ----------------------------------------------------


def decode_accdoa_to_grid_np(vectors, n_el: int = 18, n_az: int = 36, num_classes: int = 14,
                             activity_threshold: float = 0.5) -> np.ndarray:
    """numpy: (..., C, 3) vectors -> (..., G) int8 class grid
    (background = num_classes - 1); later classes overwrite a shared cell."""
    vectors = np.asarray(vectors, np.float32)
    lead = vectors.shape[:-2]
    norm = np.linalg.norm(vectors, axis=-1)  # (..., C)
    active = norm > activity_threshold
    az = np.rad2deg(np.arctan2(vectors[..., 1], vectors[..., 0]))
    el = np.rad2deg(np.arcsin(np.clip(vectors[..., 2] / np.maximum(norm, 1e-9), -1, 1)))
    i, j = polar_to_grid(az, el, n_el, n_az)
    cells = cell_index(i.astype(np.int64), j.astype(np.int64), n_az)
    grid = np.full(lead + (n_el * n_az,), num_classes - 1, np.int8)
    idx = np.nonzero(active)
    grid[tuple(idx[:-1]) + (cells[idx],)] = idx[-1]
    return grid


def decode_vote_grid_np(votes, num_classes: int = 14, min_vote: float = 0.5) -> np.ndarray:
    """numpy decode_vote_grid: the same threshold and tie-break."""
    votes = np.asarray(votes, np.float32)
    c = votes.shape[-2]
    winner = (c - 1) - np.argmax(votes[..., ::-1, :], axis=-2)
    best = votes.max(axis=-2)
    return np.where(best >= min_vote, winner, num_classes - 1).astype(np.int8)


def decode_multi_accdoa_to_grid_np(vectors, n_el: int = 18, n_az: int = 36,
                                   num_classes: int = 14,
                                   activity_threshold: float = 0.5) -> np.ndarray:
    """numpy: (..., N, C, 3) vectors -> (..., G) class grid, each track's
    single-ACCDOA decode laid over the previous tracks' where it is not
    background."""
    vectors = np.asarray(vectors, np.float32)
    grid = None
    for track in range(vectors.shape[-3]):
        g = decode_accdoa_to_grid_np(vectors[..., track, :, :], n_el, n_az, num_classes,
                                     activity_threshold)
        grid = g if grid is None else np.where(g != num_classes - 1, g, grid)
    return grid
