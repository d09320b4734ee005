"""ACS test-time augmentation (TTA): the model's predictions averaged over
the label-exact FOA scene transforms (counterpart: seld_tpu/tta.py).

Each of the 16 transforms of seld_tpu_torch.features.acs is a signed
permutation of the "mel_iv" feature planes and an exact permutation of the
label grid (and a signed permutation of direction vectors). A TTA forward
runs the model once per transform on the transformed features, maps each
output back to the original scene with the exact inverse, and averages:

  * grid models: softmax probabilities, inverse-permuted on the cell axis;
  * single-ACCDOA: the vectors, by the inverse signed permutation (a mean
    vector shrinks where the views disagree, and its norm still thresholds
    as activity);
  * multi-ACCDOA: each view decoded to its {0, 1} class-activity map (the
    track order is arbitrary per forward, so raw outputs cannot be
    averaged), inverse-permuted, averaged into votes.

The views run one after another in a Python loop (the JAX package's
lax.scan), each at the caller's batch shape, and accumulate in float32 on
the device in the order of the transforms; `fold` puts that many views
side by side in one forward's batch. Only "mel_iv" carries the signed
direction the transforms act on: other feature sets raise (acs_tables).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from seld_tpu_torch.accdoa import multi_accdoa_class_activity
from seld_tpu_torch.features.acs import N_TRANSFORMS, acs_tables, vector_tables
from seld_tpu_torch.infer import bias_background_logits

KINDS = ("grid", "accdoa", "multi_accdoa")


def validate_transforms(transforms) -> tuple:
    """A transform subset: None means all 16; otherwise unique ints in
    [0, 16)."""
    if transforms is None:
        return tuple(range(N_TRANSFORMS))
    sel = tuple(int(t) for t in transforms)
    if not sel:
        raise ValueError("TTA needs at least one transform")
    if len(set(sel)) != len(sel):
        raise ValueError(f"duplicate TTA transforms: {sel}")
    bad = [t for t in sel if not 0 <= t < N_TRANSFORMS]
    if bad:
        raise ValueError(f"TTA transforms must be in [0, {N_TRANSFORMS}); got {bad}")
    return sel


@functools.lru_cache(maxsize=16)
def _tables(n_el: int, n_az: int, feature_set: str, sel: tuple, vectors: bool):
    """Per selected view: (channel perm (V, C), channel sign (V, C), inverse
    index (V, G) or (V, 3), inverse sign (V, 3) or None) as numpy."""
    cell_gather, ch_perm, ch_sign = acs_tables(n_el, n_az, feature_set)
    rows = list(sel)
    perm = ch_perm[rows].astype(np.int64)
    if not vectors:
        # new[c] = old[cell_gather[c]]; a view's output lies in the new
        # coordinates, so original[g] = output[argsort(cell_gather)[g]]
        inv = np.stack([np.argsort(cell_gather[t]) for t in sel])
        return perm, ch_sign[rows], inv, None
    vperm, vsign = vector_tables(feature_set)
    # new[i] = old[vperm[i]] * vsign[i] with signs +-1, so
    # old[j] = new[ivp[j]] * vsign[ivp[j]]
    ivp = np.stack([np.argsort(vperm[t]) for t in sel])
    ivs = np.stack([vsign[t][ivp[i]] for i, t in enumerate(sel)])
    return perm, ch_sign[rows], ivp, ivs


def make_tta_forward(apply_fn, n_el: int, n_az: int, feature_set: str, transforms=None,
                     kind: str = "grid", activity_threshold: float = 0.5, bias_sweep=None,
                     threshold_sweep=None, fold: int = 1):
    """The TTA-averaged forward: fwd(mel (B, T, C, F)) -> float32 average
    over `transforms` in the original scene's coordinates, on mel's device.

    apply_fn(mel) -> the model's output for one feature batch.

      kind="grid":         (B, T, M, G) mean softmax probabilities;
      kind="accdoa":       (B, T, C_ev, 3) mean inverse-rotated vectors;
      kind="multi_accdoa": (B, T, C_ev, G) mean class-activity votes, each
                           view thresholded at activity_threshold
                           (decode with accdoa.decode_vote_grid).

    bias_sweep (grid only): K candidate background biases; fwd then returns
    (K, B, T, M, G), for each bias the view average of
    softmax(bias_background_logits(logits, bias)). The model runs once a
    view; only the bias, softmax and gather are replayed per candidate (the
    bias enters before the softmax of each view, so the average at one bias
    cannot be had from the average at another).

    threshold_sweep (multi_accdoa only): K candidate activity thresholds;
    fwd returns (K, B, T, C_ev, G), the votes decoded at each, the model
    once a view. Single-ACCDOA needs none: its average is vectors,
    thresholded after averaging.

    fold: that many views share one forward, concatenated along the
    batch; it must divide the number of transforms, and the sweeps take
    fold 1. A folded forward runs at another batch shape, so its average
    matches fold 1 to ~1e-6, not bit for bit; bit-equality (identity TTA
    against the plain decode, stream against offline) holds at one fold."""
    if kind not in KINDS:
        raise ValueError(f"unknown TTA kind {kind!r}")
    if bias_sweep is not None and kind != "grid":
        raise ValueError("bias_sweep applies to grid TTA only — ACCDOA decodes have no "
                         "background logit")
    if threshold_sweep is not None and kind != "multi_accdoa":
        raise ValueError(
            "threshold_sweep applies to multi_accdoa TTA only (grid decodes sweep bg_bias; "
            "single-ACCDOA averages vectors, so candidate thresholds decode from the "
            "averaged output)")
    sel = validate_transforms(transforms)
    fold = int(fold)
    if fold < 1:
        raise ValueError(f"TTA fold must be >= 1; got {fold}")
    if fold > 1 and (bias_sweep is not None or threshold_sweep is not None):
        raise ValueError("TTA fold > 1 does not compose with calibration sweeps — calibrate "
                         "at fold=1, serve the tuned point at any fold")
    if len(sel) % fold:
        raise ValueError(f"TTA fold ({fold}) must divide the number of transforms "
                         f"({len(sel)})")
    tables = _tables(n_el, n_az, feature_set, sel, kind == "accdoa")
    biases = None if bias_sweep is None else [float(b) for b in bias_sweep]
    thresholds = None if threshold_sweep is None else [float(t) for t in threshold_sweep]

    def back(out: torch.Tensor, inv: torch.Tensor, inv_sign) -> torch.Tensor:
        """One view's float32 output in its transformed coordinates -> its
        averaged quantity in the original ones (with a sweep, stacked over
        the candidates)."""
        if kind == "grid":
            if biases is None:
                return torch.softmax(out, dim=2).index_select(3, inv)
            return torch.stack([torch.softmax(bias_background_logits(out, b), dim=2)
                                .index_select(3, inv) for b in biases])
        if kind == "multi_accdoa":
            if thresholds is None:
                return multi_accdoa_class_activity(
                    out, n_el, n_az, activity_threshold).index_select(3, inv)
            return torch.stack([multi_accdoa_class_activity(out, n_el, n_az, th)
                                .index_select(3, inv) for th in thresholds])
        return out.index_select(3, inv) * inv_sign

    on_device = {}  # the tables, uploaded once per device

    @torch.no_grad()
    def fwd(mel: torch.Tensor) -> torch.Tensor:
        if mel.device not in on_device:
            on_device[mel.device] = [None if a is None else torch.from_numpy(a).to(mel.device)
                                     for a in tables]
        perm, sign, inv, inv_sign = on_device[mel.device]
        b = mel.shape[0]
        acc = None
        for start in range(0, len(sel), fold):
            views = range(start, start + fold)
            feats = torch.cat([mel.index_select(2, perm[v]) * sign[v][:, None]
                               for v in views])
            out = apply_fn(feats).float()
            for i, v in enumerate(views):
                part = back(out[i * b:(i + 1) * b], inv[v],
                            None if inv_sign is None else inv_sign[v])
                acc = part if acc is None else acc + part
        return acc / float(len(sel))

    return fwd
