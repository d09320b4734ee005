"""FOA spatial augmentation, the audio-channel-swap family "ACS"
(counterpart: seld_tpu/features/acs.py).

The 16 label-exact rigid transforms of an FOA scene: azimuth rotations by
multiples of 90 degrees, an optional azimuth reflection and an optional
elevation flip. Each is at once

  * a signed permutation of the FOA channels (W fixed, Z flips with the
    elevation, X and Y rotate and reflect), which on "mel_iv" features is
    a permutation of the log-mel planes plus a signed permutation of the
    three intensity-vector planes; and
  * an exact permutation of the 18 x 36 label grid (10-degree cells).

Only "mel_iv" carries signed direction, so only it can be augmented:
plain mel magnitudes cannot tell a scene from its reflection, and
GCC-PHAT changes sign per pair. The tables are numpy, copied from the
JAX package; `apply_acs` applies given per-sample transforms to a batch
of tensors (one channel gather and sign multiply, one cell gather), and
`make_acs_augment` builds the train step's hook that draws them from a
torch.Generator. For the ACCDOA families `apply_acs_accdoa` and
`make_acs_augment_accdoa` transform the features alike and rotate the
target vectors with the signed permutation the IV planes get: the last
axis of (B, T, C, 3) single-ACCDOA targets, axis 3 of (B, T, 6, 4, C)
ADPIT targets with their activity channel left as it is.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from seld_tpu_torch.grid import cell_centers, polar_to_grid

N_TRANSFORMS = 16

# FOA ACN channel order (STARSS22): W, Y, Z, X.
_W, _Y, _Z, _X = 0, 1, 2, 3


def transform_params(t: int) -> tuple[int, int, int]:
    """t in [0, 16) -> (k, s_az, s_el): azimuth rotation by 90k degrees
    after an optional azimuth reflection (s_az = -1: az -> -az), and an
    optional elevation flip (s_el = -1). t = 0 is the identity."""
    return t & 3, -1 if t & 4 else 1, -1 if t & 8 else 1


def transform_angles(az_deg, el_deg, t: int):
    """Transform t applied to (azimuth, elevation) degrees; the azimuth
    wraps to [-180, 180)."""
    k, s_az, s_el = transform_params(t)
    az = np.asarray(az_deg, np.float64) * s_az + 90.0 * k
    az = (az + 180.0) % 360.0 - 180.0
    return az, np.asarray(el_deg, np.float64) * s_el


def _rot_xy(k: int):
    """(x', y') = R_k (x, y) for a 90k-degree rotation as a signed
    permutation: ((src_x, sign_x), (src_y, sign_y)), src 0 is x, 1 is y."""
    return [
        ((0, 1), (1, 1)),     # 0:    x,  y
        ((1, -1), (0, 1)),    # 90:  -y,  x
        ((0, -1), (1, -1)),   # 180: -x, -y
        ((1, 1), (0, -1)),    # 270:  y, -x
    ][k]


def audio_channel_transform(t: int) -> tuple[np.ndarray, np.ndarray]:
    """(perm, sign) over the 4 ACN channels: transformed channel c is
    sign[c] * audio[perm[c]]."""
    k, s_az, s_el = transform_params(t)
    (sx, gx), (sy, gy) = _rot_xy(k)
    comp = {0: (_X, 1), 1: (_Y, s_az)}  # x comes from X, y from s_az * Y
    px, fx = comp[sx]
    py, fy = comp[sy]
    perm = np.zeros(4, np.int64)
    sign = np.zeros(4, np.float32)
    perm[_W], sign[_W] = _W, 1.0
    perm[_Z], sign[_Z] = _Z, float(s_el)
    perm[_X], sign[_X] = px, float(gx * fx)
    perm[_Y], sign[_Y] = py, float(gy * fy)
    return perm, sign


@functools.lru_cache(maxsize=8)
def acs_tables(n_el: int, n_az: int, feature_set: str = "mel_iv"):
    """(cell_gather (16, G) int32, ch_perm (16, 7) int32, ch_sign (16, 7)
    float32): augmented_mask[..., c] = mask[..., cell_gather[t, c]] and
    augmented_feat[..., c, :] = ch_sign[t, c] * feat[..., ch_perm[t, c], :].
    The cached arrays are shared: do not write to them."""
    if feature_set != "mel_iv":
        raise ValueError(
            "ACS augmentation requires signed spatial features "
            f"(feature_set='mel_iv'); got {feature_set!r} — plain mel "
            "magnitudes cannot distinguish reflections/180-deg rotations "
            "and GCC-PHAT is not sign-permutation-equivariant"
        )
    g = n_el * n_az
    el_c, az_c = cell_centers(n_el, n_az)
    el_grid = np.repeat(el_c, n_az)
    az_grid = np.tile(az_c, n_el)
    cell_gather = np.zeros((N_TRANSFORMS, g), np.int32)
    ch_perm = np.zeros((N_TRANSFORMS, 7), np.int32)
    ch_sign = np.zeros((N_TRANSFORMS, 7), np.float32)
    acn_to_iv = {_X: 4, _Y: 5, _Z: 6}  # IV planes are (X, Y, Z) at 4, 5, 6
    for t in range(N_TRANSFORMS):
        az2, el2 = transform_angles(az_grid, el_grid, t)
        i2, j2 = polar_to_grid(az2, el2, n_el, n_az)
        fwd = np.asarray(i2, np.int64) * n_az + np.asarray(j2, np.int64)
        if len(np.unique(fwd)) != g:
            raise ValueError(
                f"ACS transform {t} is not a bijection on the {n_el}x{n_az} grid — "
                "90-deg rotations need the azimuth cell width to divide 90 (e.g. "
                "n_az=36) and reflections need symmetric cell centers"
            )
        inv = np.empty(g, np.int64)
        inv[fwd] = np.arange(g)  # new cell c holds old cell inv[c]
        cell_gather[t] = inv
        perm, sign = audio_channel_transform(t)
        ch_perm[t, :4] = perm  # mel magnitudes lose the signs
        ch_sign[t, :4] = 1.0
        for acn_dst, iv_dst in acn_to_iv.items():
            ch_perm[t, iv_dst] = acn_to_iv[int(perm[acn_dst])]
            ch_sign[t, iv_dst] = sign[acn_dst]
    return cell_gather, ch_perm, ch_sign


def vector_tables(feature_set: str = "mel_iv"):
    """(perm (16, 3), sign (16, 3)): the signed permutation of (x, y, z)
    direction vectors per transform, the one the IV planes get."""
    _, ch_perm, ch_sign = acs_tables(18, 36, feature_set)
    return ch_perm[:, 4:7] - 4, ch_sign[:, 4:7]


@functools.lru_cache(maxsize=8)
def _device_tables(n_el: int, n_az: int, device: torch.device):
    cell_gather, ch_perm, ch_sign = acs_tables(n_el, n_az, "mel_iv")
    return (torch.from_numpy(cell_gather.astype(np.int64)).to(device),
            torch.from_numpy(ch_perm.astype(np.int64)).to(device),
            torch.from_numpy(ch_sign).to(device))


@functools.lru_cache(maxsize=8)
def _vector_device_tables(multi: bool, device: torch.device):
    """(perm (16, 3), sign (16, 3)) of the direction vectors, or with the
    ADPIT activity channel prepended, (16, 4), untouched."""
    vperm, vsign = vector_tables("mel_iv")
    if multi:
        vperm = np.concatenate([np.zeros((N_TRANSFORMS, 1), vperm.dtype), vperm + 1], axis=1)
        vsign = np.concatenate([np.ones((N_TRANSFORMS, 1), vsign.dtype), vsign], axis=1)
    return (torch.from_numpy(vperm.astype(np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(vsign)).to(device))


def _acs_features(feats: torch.Tensor, t: torch.Tensor, ch_perm, ch_sign) -> torch.Tensor:
    b, frames, c, f = feats.shape
    perm = ch_perm[t][:, None, :, None].expand(b, frames, c, f)
    return feats.gather(2, perm) * ch_sign[t][:, None, :, None]


def apply_acs(feats: torch.Tensor, mask: torch.Tensor, t: torch.Tensor, n_el: int,
              n_az: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform t[b] applied to sample b: feats (B, T, 7, F) "mel_iv"
    features, mask (B, T, G) label bitmask, t (B,) integer indices in
    [0, 16) on their device -> (feats, mask), new tensors."""
    cell_gather, ch_perm, ch_sign = _device_tables(n_el, n_az, feats.device)
    t = t.long()
    feats = _acs_features(feats, t, ch_perm, ch_sign)
    cells = cell_gather[t][:, None, :].expand(mask.shape)
    return feats, mask.gather(2, cells)


def apply_acs_accdoa(feats: torch.Tensor, targets: torch.Tensor, t: torch.Tensor,
                     multi: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform t[b] applied to sample b of "mel_iv" features and ACCDOA
    targets: (B, T, C, 3) vectors, or with multi (B, T, 6, 4, C) ADPIT
    slots -> (feats, targets), new tensors."""
    _, ch_perm, ch_sign = _device_tables(18, 36, feats.device)
    perm, sign = _vector_device_tables(multi, feats.device)
    t = t.long()
    feats = _acs_features(feats, t, ch_perm, ch_sign)
    if multi:  # permute and sign axis 3, [activity, x, y, z]
        idx, s = perm[t][:, None, None, :, None], sign[t][:, None, None, :, None]
    else:  # permute and sign the last axis, (x, y, z)
        idx, s = perm[t][:, None, None, :], sign[t][:, None, None, :]
    return feats, targets.gather(3, idx.expand(targets.shape)) * s


def make_acs_augment(n_el: int, n_az: int, feature_set: str = "mel_iv"):
    """The train step's hook: augment(generator, feats (B, T, C, F), mask
    (B, T, G)) -> (feats, mask), one transform per sample drawn uniformly
    from `generator` (on the features' device). Raises ValueError unless
    feature_set is "mel_iv"."""
    acs_tables(n_el, n_az, feature_set)

    def augment(generator: torch.Generator, feats: torch.Tensor, mask: torch.Tensor):
        t = torch.randint(0, N_TRANSFORMS, (feats.shape[0],), generator=generator,
                          device=feats.device)
        return apply_acs(feats, mask, t, n_el, n_az)

    return augment


def make_acs_augment_accdoa(feature_set: str = "mel_iv", multi: bool = False):
    """The train step's hook for ACCDOA-family targets: augment(generator,
    feats, targets) -> (feats, targets), one transform per sample drawn as
    make_acs_augment draws it; targets (B, T, C, 3) vectors or, with
    multi, (B, T, 6, 4, C) ADPIT slots. Raises ValueError unless
    feature_set is "mel_iv"."""
    acs_tables(18, 36, feature_set)

    def augment(generator: torch.Generator, feats: torch.Tensor, targets: torch.Tensor):
        t = torch.randint(0, N_TRANSFORMS, (feats.shape[0],), generator=generator,
                          device=feats.device)
        return apply_acs_accdoa(feats, targets, t, multi)

    return augment
