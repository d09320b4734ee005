"""Composite SMR-SELD loss: class CE or MSE, AIUR and converging
localization (counterpart: seld_tpu/losses/seld_loss.py).

All dense operands (logits, one-hot targets, probabilities) are
class-major (B, T, M, G): softmax and argmax reduce over axis -2.

  * class_ce_loss: one-hot targets collapsed by argmax, weighted cross
    entropy sum(w_y * nll) / sum(w_y) (events 1.0, background 0.05).
  * class_mse_loss: softmax over classes, plain MSE against the one-hot.
  * aiur_loss: 1 - mean IoU of predicted and true non-background argmax
    masks per (B, T); empty against empty counts 1. Piecewise constant:
    its gradient is zero, as in the reference.
  * converging_localization_loss: targets remapped to {1, -N_bac/N_non},
    an 8-neighbour averaged-difference map with circular wrap on both grid
    axes, dotted with the predicted non-background activity on event
    frames.

Under a process mesh of more than one rank (parallel.sequence.attention_mesh)
each rank holds its block of the global batch's logits and returns its
part of the loss: its local sums over the GLOBAL normaliser (the example
count, the class weights' sum), all-reduced over the world, so that the
parts add up to the one-device loss and their gradients, summed over the
ranks, to its gradient. The AIUR and converging-localization terms are
refused there (ROADMAP item 10's remainder).

The *_bits terms take the (B, T, G) class bitmask instead of dense
targets, with elementwise-identical arithmetic: argmax of a multi-hot
one-hot is its lowest set bit; argmax != background is mask != 0; the sum
of the event-class targets is popcount(mask). Masks are integer tensors
(int16 as the batches carry them) and are widened to int32 before any
shift.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from seld_tpu_torch.config import GridConfig, LossConfig
from seld_tpu_torch.ops.loss_cuda import grid_loss_terms
from seld_tpu_torch.parallel.sequence import world_mesh
from seld_tpu_torch.targets.rasterize import decode_class_bitmask

EPS = 1e-10


def make_class_weights(num_classes: int, background_weight: float = 0.05) -> torch.Tensor:
    """Events 1.0, the background (last) class down-weighted."""
    w = torch.ones(num_classes)
    w[num_classes - 1] = background_weight
    return w


def _example_weights(example_mask, batch: int, device) -> torch.Tensor:
    """(B,) float validity weights; None -> all ones. A padded tail batch
    carries a mask so that its padding rows add nothing."""
    if example_mask is None:
        return torch.ones(batch, device=device)
    return example_mask.float()


def _global_count(count: torch.Tensor) -> torch.Tensor:
    """A loss's normaliser over the global batch: this rank's count summed
    over the world under a multi-rank mesh (a constant of the parameters:
    no gradient flows through it), else the count itself."""
    mesh = world_mesh()
    if mesh is None:
        return count
    count = count.detach().clone()
    dist.all_reduce(count, group=mesh.world)
    return count


def _weighted_mean(per_example: torch.Tensor, em: torch.Tensor) -> torch.Tensor:
    """The em-weighted mean over the batch of per-example means. Under a
    mesh each rank's per-example means cover its time chunk: the world's sum
    of em counts each row once per chunk, which turns them into the
    window's means."""
    return (per_example * em).sum() / _global_count(em.sum()).clamp_min(1e-8)


def _weighted_nll(logits, labels, class_weights, example_mask):
    logp = torch.log_softmax(logits.float(), dim=-2)
    nll = -logp.gather(-2, labels.unsqueeze(-2)).squeeze(-2)
    w = torch.ones_like(nll) if class_weights is None else class_weights.to(nll.device)[labels]
    em = _example_weights(example_mask, logits.shape[0], logits.device)
    em = em.reshape((-1,) + (1,) * (nll.dim() - 1))
    return (w * nll * em).sum() / _global_count((w * em).sum()).clamp_min(1e-8)


def class_ce_loss(logits, targets, class_weights=None, example_mask=None):
    """Weighted cross entropy against the argmax of the one-hot targets."""
    return _weighted_nll(logits, targets.argmax(dim=-2), class_weights, example_mask)


def class_mse_loss(logits, targets, example_mask=None):
    """softmax(logits) against one-hot targets, mean over every element."""
    sq = (torch.softmax(logits.float(), dim=-2) - targets).square()
    em = _example_weights(example_mask, logits.shape[0], logits.device)
    return _weighted_mean(sq.reshape(sq.shape[0], -1).mean(dim=-1), em)


def _aiur(logits, true_mask, example_mask):
    bg = logits.shape[-2] - 1
    pred_mask = (logits.argmax(dim=-2) != bg).float()  # (B, T, G)
    intersection = (pred_mask * true_mask).sum(-1)  # (B, T)
    union = pred_mask.sum(-1) + true_mask.sum(-1) - intersection
    iou = torch.where(union > 0, intersection / (union + 1e-8), torch.ones_like(union))
    em = _example_weights(example_mask, logits.shape[0], logits.device)[:, None]
    return 1.0 - (iou * em).sum() / (em.sum() * iou.shape[1]).clamp_min(1e-8)


def aiur_loss(logits, targets, example_mask=None):
    """1 - mean frame IoU of the non-background argmax masks."""
    bg = logits.shape[-2] - 1
    return _aiur(logits, (targets.argmax(dim=-2) != bg).float(), example_mask)


def _converging_localization(pred_nonbg, true_nonbg, example_mask):
    """pred_nonbg, true_nonbg: (B, T, I, J) predicted and true event
    activity per cell."""
    n_el, n_az = true_nonbg.shape[2:]
    is_event = true_nonbg > 0.01
    n_bac = (~is_event).sum(dim=(2, 3), keepdim=True).float()
    n_non = is_event.sum(dim=(2, 3), keepdim=True).float()
    y_prime = torch.where(is_event, -(n_bac / (n_non + EPS)), 1.0)

    # neighbour (di, dj) of cell (i, j) is y[(i+di) % I, (j+dj) % J]
    diff_sum = torch.zeros_like(y_prime)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            neighbor = torch.roll(y_prime, shifts=(-di, -dj), dims=(2, 3))
            diff_sum = diff_sum + (neighbor - y_prime)
    y_at = y_prime + diff_sum / 8.0

    em = _example_weights(example_mask, true_nonbg.shape[0], true_nonbg.device)
    has_events = (n_non > 0).float() * em.reshape(-1, 1, 1, 1)
    return (pred_nonbg * y_at * has_events).sum() / (has_events.sum() * n_el * n_az + EPS)


def converging_localization_loss(logits_or_probs, targets, n_el: int, n_az: int,
                                 from_logits: bool = True, example_mask=None):
    """Attention-weighted localization convergence term."""
    b, t, m, g = targets.shape
    probs = (torch.softmax(logits_or_probs.float(), dim=-2) if from_logits
             else logits_or_probs.float())
    pred_nonbg = probs[:, :, :-1].sum(dim=2).reshape(b, t, n_el, n_az)
    true_nonbg = targets.float()[:, :, :-1].sum(dim=2).reshape(b, t, n_el, n_az)
    return _converging_localization(pred_nonbg, true_nonbg, example_mask)


class LossOutput(NamedTuple):
    total: torch.Tensor
    breakdown: dict


def _bit_targets(mask, num_classes: int):
    """Class-major one-hot from the bitmask: (..., G) -> (..., M, G)."""
    return decode_class_bitmask(mask, num_classes, class_major=True)


def _popcount16(x):
    """Popcount of 16-bit payloads carried in int32."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def _bit_labels(mask, num_classes: int):
    """argmax of the decoded one-hot: the lowest set bit, else background."""
    m = mask.to(torch.int32)
    lsb_index = _popcount16((m & -m) - 1)
    return torch.where(m == 0, num_classes - 1, lsb_index).long()


def class_mse_loss_bits(logits, mask, num_classes: int, example_mask=None, probs=None):
    """class_mse_loss from the bitmask."""
    if probs is None:
        probs = torch.softmax(logits.float(), dim=-2)
    sq = (probs - _bit_targets(mask, num_classes)).square()
    em = _example_weights(example_mask, logits.shape[0], logits.device)
    return _weighted_mean(sq.reshape(sq.shape[0], -1).mean(dim=-1), em)


def class_ce_loss_bits(logits, mask, num_classes: int, class_weights=None,
                       example_mask=None):
    """class_ce_loss from the bitmask."""
    return _weighted_nll(logits, _bit_labels(mask, num_classes), class_weights,
                         example_mask)


def aiur_loss_bits(logits, mask, example_mask=None):
    """aiur_loss from the bitmask."""
    return _aiur(logits, (mask != 0).float(), example_mask)


def converging_localization_loss_bits(logits, mask, n_el: int, n_az: int,
                                      example_mask=None, probs=None, pred_nonbg=None):
    """converging_localization_loss from the bitmask. `pred_nonbg`
    (B, T, G) may be given directly: the K2 path passes 1 - p_bg, equal to
    the sum of the event-class probabilities."""
    b, t, g = mask.shape
    if pred_nonbg is None:
        if probs is None:
            probs = torch.softmax(logits.float(), dim=-2)
        pred_nonbg = probs[:, :, :-1].sum(dim=2)
    true_nonbg = _popcount16(mask.to(torch.int32)).float()
    return _converging_localization(pred_nonbg.reshape(b, t, n_el, n_az),
                                    true_nonbg.reshape(b, t, n_el, n_az), example_mask)


class SELDLossFn:
    """The configured composite loss: __call__(logits, dense targets) or
    from_bitmask(logits, bitmask) -> (total, breakdown of scalar tensors)."""

    def __init__(self, cfg: LossConfig, grid: GridConfig, class_weights=None):
        if cfg.loss_type not in ("mse", "ce"):
            raise ValueError(f"unknown loss_type {cfg.loss_type!r}")
        self.cfg = cfg
        self.grid = grid
        if class_weights is None and cfg.loss_type == "ce":
            class_weights = make_class_weights(grid.num_classes, cfg.background_class_weight)
        self.class_weights = class_weights

    def _class_weights_on(self, device):
        if self.class_weights is not None and self.class_weights.device != device:
            self.class_weights = self.class_weights.to(device)
        return self.class_weights

    def _with_aux_terms(self, loss_class, aiur, cl) -> LossOutput:
        """total and breakdown from the class term and the optional terms
        (`aiur` and `cl` are thunks, called only when the config uses them)."""
        cfg = self.cfg
        if (cfg.use_aiur or cfg.use_cl) and world_mesh() is not None:
            raise NotImplementedError(
                "loss.use_aiur / loss.use_cl under a process mesh of more than one rank "
                "are not ported (ROADMAP item 10's remainder)")
        total = cfg.w_class * loss_class
        breakdown = {f"class_{cfg.loss_type}": loss_class}
        if cfg.use_aiur:
            breakdown["aiur"] = aiur()
            total = total + cfg.w_aiur * breakdown["aiur"]
        if cfg.use_cl:
            breakdown["cl"] = cl()
            total = total + cfg.w_cl * breakdown["cl"]
        return LossOutput(total, breakdown)

    def __call__(self, logits, targets, example_mask=None) -> LossOutput:
        if self.cfg.loss_type == "mse":
            loss_class = class_mse_loss(logits, targets, example_mask)
        else:
            loss_class = class_ce_loss(
                logits, targets, self._class_weights_on(logits.device), example_mask
            )
        return self._with_aux_terms(
            loss_class,
            lambda: aiur_loss(logits, targets, example_mask),
            lambda: converging_localization_loss(
                logits, targets, self.grid.n_el, self.grid.n_az,
                example_mask=example_mask),
        )

    def from_bitmask(self, logits, label_mask, example_mask=None,
                     fused: bool | None = None) -> LossOutput:
        """The composite loss straight from the (B, T, G) bitmask, equal in
        value to __call__ on the decoded one-hot.

        `fused` selects kernel K2 (seld_tpu_torch.ops.loss_cuda) for the
        MSE softmax region. None resolves by device, as every kernel
        wrapper of this package does: CUDA logits go through K2, CPU logits
        through the unfused torch ops. False keeps the unfused ops on any
        device (the oracle, and what K2 is timed against). True forces K2
        and raises for CPU logits. K2 computes only the MSE region: with
        loss_type="ce" every value of `fused` takes the unfused ops."""
        if fused not in (None, False, True):
            raise ValueError(f"fused must be None, False or True, got {fused!r}")
        cfg = self.cfg
        nc = self.grid.num_classes
        if fused and not logits.is_cuda:
            raise ValueError(
                f"fused=True launches kernel K2 and needs CUDA logits, got {logits.device}"
            )
        if fused is None:
            fused = logits.is_cuda
        if fused and cfg.loss_type == "mse":
            return self._from_bitmask_fused(logits, label_mask, example_mask)
        probs = (torch.softmax(logits.float(), dim=-2)
                 if cfg.loss_type == "mse" or cfg.use_cl else None)
        if cfg.loss_type == "mse":
            loss_class = class_mse_loss_bits(logits, label_mask, nc, example_mask, probs=probs)
        else:
            loss_class = class_ce_loss_bits(
                logits, label_mask, nc, self._class_weights_on(logits.device), example_mask
            )
        return self._with_aux_terms(
            loss_class,
            lambda: aiur_loss_bits(logits, label_mask, example_mask),
            lambda: converging_localization_loss_bits(
                logits, label_mask, self.grid.n_el, self.grid.n_az,
                example_mask=example_mask, probs=probs),
        )

    def _from_bitmask_fused(self, logits, label_mask, example_mask=None) -> LossOutput:
        """The MSE family through `grid_loss_terms`: one pass gives the
        squared-error cell sums and the background plane; AIUR's
        zero-gradient argmax stays in torch ops. The logits must be float32
        and contiguous, as the grid head emits them; nothing is cast here."""
        b, t, m, g = logits.shape
        sq, pbg = grid_loss_terms(
            logits.reshape(b * t, m, g), label_mask.reshape(b * t, g),
            self.grid.num_classes,
        )
        em = _example_weights(example_mask, b, logits.device)
        loss_class = _weighted_mean(sq.reshape(b, t * g).sum(dim=1) / (t * g * m), em)
        return self._with_aux_terms(
            loss_class,
            lambda: aiur_loss_bits(logits, label_mask, example_mask),
            lambda: converging_localization_loss_bits(
                logits, label_mask, self.grid.n_el, self.grid.n_az,
                example_mask=example_mask, pred_nonbg=(1.0 - pbg).reshape(b, t, g)),
        )
