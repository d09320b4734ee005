"""Knowledge distillation: train a small student against a trained teacher
(counterpart: seld_tpu/distill.py).

A serving lever beside int8 PTQ and QAT (seld_tpu_torch.quant): train a
cheap model (a CRNN, a Conformer) to mimic the flagship ResNet50-Conformer,
then serve the student, int8 if wanted.

Config-driven (`train.distill_ckpt` with `distill_alpha`,
`distill_temperature` and `distill_track_matching`):

  * `load_teacher` builds the teacher from the config stored in its
    checkpoint tree and loads the best checkpoint (the EMA weights when the
    teacher trained with `train.ema_decay`), else the newest rolling one.
    It reads the port's own checkpoint files (train/checkpoint.py); a
    checkpoint tree that the JAX package wrote (orbax) is not read here.
  * The train step runs the teacher's eval-mode forward under no_grad on
    the same augmented features the student sees, outside quant.qat() (only
    the student is fake-quantized), and trains on
    `(1 - alpha) * hard_loss + alpha * kd_loss`, where the KD term follows
    the output representation:
      - grid heads (class-major (B, T, M, G) logits): the temperature-scaled
        KL(teacher || student) over the class axis, times T^2 (Hinton et
        al. 2015), each cell weighted by the hard CE's class weight of the
        teacher's predicted class (uniform KD over a ~99 %-background grid
        drowns the event signal);
      - ACCDOA heads: the masked MSE between the two sets of vectors;
      - multi-ACCDOA heads: that MSE made invariant to the order of the
        teacher's tracks, per (frame, class): the min over the N! orderings,
        as the hard ADPIT loss matches tracks
        (`train.distill_track_matching=position` is the slot-wise MSE).
    Both vector KDs weight a (frame, class) cell by the teacher's decoded
    activity: `loss.background_class_weight` where every track's vector is
    at most the 0.5 decode threshold long, 1.0 elsewhere.

Teacher and student must consume the same corpus (features, window and
grid sections equal) and emit the same kind of output; the teacher's
architecture is free. Every loss here is plain PyTorch in float32: the JAX
package computes them outside any Pallas kernel too.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Callable

import torch
from torch import nn


def grid_kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 example_mask: torch.Tensor | None = None, temperature: float = 1.0,
                 class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Temperature-scaled KL(teacher || student) over the class axis -2 of
    class-major (B, T, M, G) logits, in float32 and in log space.

    Each cell's KL is weighted by `class_weights[teacher argmax class]` and
    the total normalised as `sum(w * kl * em) / max(sum(w * em), 1e-8)`,
    as the class-weighted hard CE is; `class_weights=None` is the uniform
    cell mean. Scaled by temperature**2."""
    s = student_logits.float() / temperature
    t = teacher_logits.float() / temperature
    log_ps = torch.log_softmax(s, dim=-2)
    log_pt = torch.log_softmax(t, dim=-2)
    kl = torch.sum(log_pt.exp() * (log_pt - log_ps), dim=-2)  # (B, T, G)
    if class_weights is None:
        w = torch.ones_like(kl)
    else:  # the argmax does not depend on the temperature: the teacher's class
        w = class_weights.to(kl.device)[torch.argmax(teacher_logits, dim=-2)]
    em = _example_weights(example_mask, kl)
    kl = torch.sum(w * kl * em) / torch.sum(w * em).clamp_min(1e-8)
    return kl * temperature ** 2


def _example_weights(example_mask, per_cell: torch.Tensor) -> torch.Tensor:
    """(B, 1, ...) float32 example weights broadcasting over per_cell."""
    em = (torch.ones(per_cell.shape[0], device=per_cell.device) if example_mask is None
          else example_mask.float())
    return em.reshape((-1,) + (1,) * (per_cell.ndim - 1))


def _teacher_activity_weights(teacher_vectors: torch.Tensor, background_weight: float,
                              activity_threshold: float) -> torch.Tensor:
    """Per-(frame, class) weights from the teacher's decoded activity: 1.0
    where any track's vector is longer than the decode threshold,
    `background_weight` elsewhere. Input (B, T, C, 3) or (B, T, N, C, 3);
    returns (B, T, C)."""
    active = torch.linalg.vector_norm(teacher_vectors.float(), dim=-1) > activity_threshold
    if active.ndim == 4:  # (B, T, N, C): any track activates the cell
        active = active.any(dim=2)
    return torch.where(active, 1.0, float(background_weight))


def _weighted_cell_mean(per_cell: torch.Tensor, weights: torch.Tensor | None,
                        example_mask) -> torch.Tensor:
    """`sum(w * x * em) / max(sum(w * em), 1e-8)` over (B, T, C) cells;
    `weights=None` is the uniform mean."""
    if weights is None:
        weights = torch.ones_like(per_cell)
    em = _example_weights(example_mask, per_cell)
    return torch.sum(weights * per_cell * em) / torch.sum(weights * em).clamp_min(1e-8)


def vector_kd_loss(student_vectors: torch.Tensor, teacher_vectors: torch.Tensor,
                   example_mask: torch.Tensor | None = None, temperature: float = 1.0,
                   background_weight: float | None = None,
                   activity_threshold: float = 0.5) -> torch.Tensor:
    """Masked MSE between ACCDOA vectors, (B, T, C, 3) or track-major
    (B, T, N, C, 3) (then per (frame, class) over tracks and axes).

    `temperature` is taken for the interface and ignored: an MSE between
    bounded regression outputs has nothing to soften. With
    `background_weight` the cells where the teacher is inactive weigh that
    much (see `_teacher_activity_weights`), and the total is renormalised by
    the weight mass."""
    del temperature
    s, t = student_vectors.float(), teacher_vectors.float()
    sq = torch.square(s - t)
    per_cell = sq.mean(dim=(2, 4)) if sq.ndim == 5 else sq.mean(dim=-1)
    w = None if background_weight is None else _teacher_activity_weights(
        t, background_weight, activity_threshold)
    return _weighted_cell_mean(per_cell, w, example_mask)


def multi_accdoa_kd_loss(student_vectors: torch.Tensor, teacher_vectors: torch.Tensor,
                         example_mask: torch.Tensor | None = None, temperature: float = 1.0,
                         background_weight: float | None = None,
                         activity_threshold: float = 0.5) -> torch.Tensor:
    """Track-permutation-invariant KD for multi-ACCDOA heads, on
    (B, T, N, C, 3) vectors: per (frame, class) the least MSE over (track,
    axis) among the N! orderings of the teacher's tracks, the granularity of
    the hard ADPIT loss. The identity ordering is a candidate, so this is at
    most the slot-wise `vector_kd_loss`. Ties share the gradient equally
    (torch.amin), as jnp.min's does. `temperature` is ignored;
    `background_weight` as in `vector_kd_loss`."""
    del temperature
    s, t = student_vectors.float(), teacher_vectors.float()
    if s.ndim != 5:
        raise ValueError(
            f"multi_accdoa_kd_loss expects (B, T, N, C, 3) track-major "
            f"vectors, got shape {tuple(s.shape)}"
        )
    per_perm = torch.stack(
        [torch.square(s - t[:, :, list(perm)]).mean(dim=(2, 4))
         for perm in itertools.permutations(range(s.shape[2]))])
    per_frame_class = torch.amin(per_perm, dim=0)  # (B, T, C)
    w = None if background_weight is None else _teacher_activity_weights(
        t, background_weight, activity_threshold)
    return _weighted_cell_mean(per_frame_class, w, example_mask)


@dataclass(frozen=True)
class DistillSpec:
    """What the train step needs to add a KD term: the teacher (an eval-mode
    module on the run's device, no gradients) and
    `kd(student_out, teacher_out, example_mask, temperature=...)`, the
    representation-matched loss."""

    teacher: nn.Module
    kd: Callable[..., torch.Tensor]
    alpha: float
    temperature: float


def _model_kind(model_type: str) -> str:
    from seld_tpu_torch.models.registry import ACCDOA_MODELS, MULTI_ACCDOA_MODELS

    if model_type in MULTI_ACCDOA_MODELS:
        return "multi_accdoa"
    if model_type in ACCDOA_MODELS:
        return "accdoa"
    return "grid"


def teacher_variable_count(model: nn.Module) -> int:
    """The model's variables as flax counts them: its parameters and
    BatchNorm statistics, less the r and z hidden biases that torch's GRU
    carries and flax folds into the input biases (2 x hidden a direction
    and layer)."""
    count = sum(p.numel() for p in model.parameters())
    count += sum(b.numel() for name, b in model.named_buffers()
                 if name.endswith(("running_mean", "running_var")))
    for gru in (m for m in model.modules() if isinstance(m, nn.GRU)):
        count -= sum(2 * gru.hidden_size for name, _ in gru.named_parameters()
                     if name.startswith("bias_hh"))
    return count


def load_teacher(cfg, checkpoint_dir, device: str | torch.device | None = None):
    """Load the teacher of `train.distill_ckpt` onto `device` (CUDA unless
    named). Returns (spec: DistillSpec, meta of the checkpoint loaded).

    The teacher's input contract (features, window and grid sections) must
    equal the student's, since both read the same corpus batches, and the
    output kinds must match: named errors otherwise. Its architecture comes
    from the config stored in its checkpoints. Only the model's state_dict
    reaches the device; the stored Adam moments are dropped on the CPU."""
    from seld_tpu_torch import resolve_device
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.losses.seld_loss import make_class_weights
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint_config
    from seld_tpu_torch.train.state import TrainState

    device = resolve_device(device)
    checkpoint_dir = Path(checkpoint_dir)
    stored = load_checkpoint_config(checkpoint_dir)
    if stored is None:
        raise FileNotFoundError(
            f"train.distill_ckpt: no checkpoint config under {checkpoint_dir}"
        )
    for section in ("features", "window", "grid"):
        if getattr(stored, section) != getattr(cfg, section):
            raise ValueError(
                f"train.distill_ckpt: teacher {section} config differs from "
                f"the student's — teacher and student must consume the same "
                f"corpus (teacher {getattr(stored, section)!r} vs student "
                f"{getattr(cfg, section)!r})"
            )
    t_kind = _model_kind(stored.model.model_type)
    s_kind = _model_kind(cfg.model.model_type)
    if t_kind != s_kind:
        raise ValueError(
            f"train.distill_ckpt: teacher emits {t_kind!r} outputs but the "
            f"student emits {s_kind!r} — cross-representation distillation "
            f"is unsupported (teacher {stored.model.model_type}, student "
            f"{cfg.model.model_type})"
        )
    # (multi-ACCDOA track counts are fixed per model type in the registry,
    # so equal kinds already mean equal track layouts)
    if t_kind == "grid":
        # the hard CE's background down-weighting on the teacher's class;
        # loss.background_class_weight=1.0 is uniform KD
        kd = partial(grid_kd_loss, class_weights=make_class_weights(
            cfg.grid.num_classes, cfg.loss.background_class_weight).to(device))
    else:
        kd = vector_kd_loss
        if t_kind == "multi_accdoa":
            matching = cfg.train.distill_track_matching
            if matching == "permutation":
                kd = multi_accdoa_kd_loss
            elif matching != "position":
                raise ValueError(
                    f"train.distill_track_matching must be 'permutation' or "
                    f"'position', got {matching!r}"
                )
        # the teacher-activity cell weighting, the vector analogue of the
        # grid branch's class weighting, shares its knob
        kd = partial(kd, background_weight=float(cfg.loss.background_class_weight))

    tcfg = cfg.replace_path("model", stored.model)
    teacher = build_model(tcfg.model, tcfg.grid, device=device, seed=None,
                          in_channels=feature_channels(tcfg.features.feature_set,
                                                       tcfg.model.n_channels))
    ckpt = CheckpointManager(checkpoint_dir, tcfg)
    state = TrainState(step=0, model=teacher, optimizer=None)  # no moments restored
    restored = ckpt.restore_best(state) or ckpt.restore_latest(state)
    if restored is None:
        raise FileNotFoundError(
            f"train.distill_ckpt: no checkpoint found under {checkpoint_dir}"
        )
    teacher.requires_grad_(False).eval()
    spec = DistillSpec(teacher=teacher, kd=kd, alpha=float(cfg.train.distill_alpha),
                       temperature=float(cfg.train.distill_temperature))
    return spec, restored[1]
