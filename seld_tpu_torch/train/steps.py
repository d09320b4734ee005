"""Train and eval steps (counterpart: seld_tpu/train/steps.py).

A step is eager PyTorch: model forward (bf16 convolutions and linears on
float32 parameters, or on bf16 ones with model.param_dtype=bfloat16, whose
gradients are then bf16 too), the composite loss straight from the class bitmask
(`loss_fn.from_bitmask`, which on the card runs the softmax region through
kernel K2, forward and backward), backward, one Adam update. The batch
comes in and a handful of scalar metrics go out as device tensors: nothing
here reads a value back to the host. A loss without `from_bitmask` (the
ACCDOA and ADPIT losses of seld_tpu_torch.accdoa) takes the batch's
targets as they come, ACCDOA vectors, in place of the bitmask.

Under a process mesh (`mesh`, with `time_sharded` for sequence
parallelism) every rank calls the step with the same global batch. The
step augments the global rows (so SpecAugment and ACS draw what the
one-device step draws), keeps this rank's rows and time chunk
(parallel.sharding.shard_batch) and runs the model, the loss and the
backward on them inside `attention_mesh`, where the layers exchange halos,
BatchNorm and the loss take global statistics and attention runs the ring
(K5). The gradients are then summed over every rank before anything
reads them, so Adam takes the same step on every replica, and the metrics
are the loss's parts summed over the world: the one-device values.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from seld_tpu_torch import no_tf32, quant
from seld_tpu_torch.infer import bias_background_logits
from seld_tpu_torch.losses import SELDLossFn
from seld_tpu_torch.losses.seld_loss import _bit_labels
from seld_tpu_torch.ops.attention import attention_mesh
from seld_tpu_torch.parallel.sharding import shard_batch
from seld_tpu_torch.train.state import TrainState


QAT_MESH_ERROR = ("train.qat under a process mesh of more than one rank is not ported "
                  "(ROADMAP item 10's remainder: fake-quant's live absmax would be each "
                  "rank's own)")


DISTILL_MESH_ERROR = ("train.distill_ckpt under a process mesh of more than one rank is not "
                      "ported (ROADMAP item 10's remainder: the KD term's normaliser "
                      "sum(w * em) would be each rank's own)")


ACCUM_BF16_PARAMS_ERROR = (
    "train.accum_steps > 1 with model.param_dtype=bfloat16 is refused: the JAX "
    "package's accumulation adds share * gradient, which promotes the bf16 gradient "
    "sum to float32, and its scan raises TypeError (seld_tpu/train/steps.py:229-236)")


def _true_f32(model: nn.Module):
    """A float32 model computes in true float32: TF32 off around the
    forward and the backward (the model's own forward only covers itself)."""
    if getattr(model, "compute_dtype", None) == torch.float32:
        return no_tf32()
    return contextlib.nullcontext()


def dropout_seed(rng: tuple[int, ...], step: int) -> int:
    """The dropout generator's seed for one step: a pure function of the
    run's (seed, epoch) and the step counter, so a resumed run repeats the
    run it resumes."""
    return int(np.random.SeedSequence((*rng, step)).generate_state(1, np.uint64)[0] >> 1)


def augment_seed(rng: tuple[int, ...], step: int) -> int:
    """The augmentation generator's seed for one step: like dropout_seed,
    a pure function of (seed, epoch) and the step counter, from its own
    stream."""
    return int(np.random.SeedSequence((*rng, step, 1)).generate_state(1, np.uint64)[0] >> 1)


def _sum_over_world(mesh, tensors) -> None:
    """Sum the tensors over every rank of the mesh, in place, as one
    all-reduce of their concatenation per dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.world)
        torch._foreach_copy_(group, [f.view_as(t) for f, t in
                                     zip(flat.split([t.numel() for t in group]), group)])


def _global_metrics(mesh, metrics: dict) -> dict:
    """The ranks' loss parts summed over the world (the one-device values)."""
    if mesh is None or mesh.world_size == 1:
        return metrics
    keys = list(metrics)
    values = [metrics[k].detach().float().reshape(1).clone() for k in keys]
    _sum_over_world(mesh, values)
    return {k: v.reshape(()) for k, v in zip(keys, values)}


def _loss(loss_fn, out, targets, example_mask):
    """(total, breakdown): a grid loss straight from the bitmask, any other
    loss (ACCDOA, ADPIT) from its own targets."""
    if hasattr(loss_fn, "from_bitmask"):
        return loss_fn.from_bitmask(out, targets, example_mask)
    return loss_fn(out, targets, example_mask)


def _check_classes(loss_fn, num_classes: int) -> None:
    grid = getattr(loss_fn, "grid", None)
    if grid is not None and num_classes != grid.num_classes:
        raise ValueError(f"num_classes {num_classes} != the loss's grid ({grid.num_classes})")


def make_train_step(model: nn.Module, loss_fn: SELDLossFn,
                    optimizer: torch.optim.Optimizer, num_classes: int,
                    accum_steps: int = 1, input_augment=None, spatial_augment=None,
                    mesh=None, time_sharded: bool = False, qat: bool = False,
                    distill=None):
    """Returns step(state, mel, targets, example_mask, rng) ->
    (state, metrics).

    mel (B, T, C, F) float32, targets the (B, T, G) integer label bitmask
    (or, for a loss without from_bitmask, its ACCDOA targets), example_mask
    (B,) validity weights or None, all on the model's device;
    rng a tuple of ints, (seed, epoch) in the trainer. The step updates the
    model, the optimizer and state.step in place. metrics holds "loss" and
    the loss breakdown as detached device scalars.

    accum_steps > 1 splits the batch into that many microbatches, runs
    them in order (BatchNorm statistics thread through them) and adds their
    gradients weighted by each microbatch's share of the example-mask
    weight, then applies one optimizer update. For the em-normalised
    decomposable terms (MSE, AIUR) that equals the full-batch gradient,
    padded tail batches included: an all-padding microbatch adds 0.

    spatial_augment(generator, mel, targets) -> (mel, targets)
    transforms features and targets together (the ACS scene transforms);
    input_augment(generator, mel) -> mel transforms the features
    (SpecAugment). Both are train-side only and run in that order on the
    whole batch before any microbatch split, drawing from one generator
    on the batch's device seeded with augment_seed(rng, step).

    qat=True trains quantization-aware: the forward runs inside
    quant.qat(), where the eligible layers (the int8 PTQ set) fake-quantize
    their inputs and weights with straight-through gradients; a remat
    recompute does too.

    distill (seld_tpu_torch.distill.DistillSpec) adds knowledge
    distillation: per batch, or per microbatch under accumulation, the
    teacher runs its eval-mode forward under no_grad on the mel the student
    sees (after ACS, SpecAugment and shard_batch, inside the same
    attention_mesh, outside quant.qat(): only the student is
    fake-quantized; in true float32 for a float32 teacher) and the loss
    becomes (1 - alpha) * hard + alpha * kd, with "hard" and "kd" in the
    breakdown. The teacher draws from no generator, so the student's
    dropout and augmentation are those of the plain step.

    With a `mesh` the step takes the global batch and trains on this
    rank's block of it (see the module's note); accum_steps must be 1, and
    qat and distill need a mesh of one rank."""
    if mesh is not None and accum_steps != 1:
        raise NotImplementedError(
            "train.accum_steps > 1 under a process mesh is not ported "
            "(ROADMAP item 10's remainder)")
    if qat and mesh is not None and mesh.world_size > 1:
        raise NotImplementedError(QAT_MESH_ERROR)
    if distill is not None and mesh is not None and mesh.world_size > 1:
        raise NotImplementedError(DISTILL_MESH_ERROR)
    _check_classes(loss_fn, num_classes)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if accum_steps > 1 and any(p.dtype == torch.bfloat16 for p in model.parameters()):
        raise ValueError(ACCUM_BF16_PARAMS_ERROR)

    generator = None

    def forward_loss(mel, targets, example_mask):
        with quant.qat(qat):
            out = model(mel)
        total, breakdown = _loss(loss_fn, out, targets, example_mask)
        if distill is None:
            return total, breakdown
        with torch.no_grad(), _true_f32(distill.teacher):
            t_out = distill.teacher(mel)
        kd = distill.kd(out, t_out, example_mask, temperature=distill.temperature)
        return ((1.0 - distill.alpha) * total + distill.alpha * kd,
                {**breakdown, "hard": total, "kd": kd})

    def step(state: TrainState, mel, targets, example_mask, rng):
        nonlocal generator
        model.train()
        model.seed_dropout(dropout_seed(rng, state.step))
        if spatial_augment is not None or input_augment is not None:
            if generator is None:
                generator = torch.Generator(device=mel.device)
            generator.manual_seed(augment_seed(rng, state.step))
            if spatial_augment is not None:
                mel, targets = spatial_augment(generator, mel, targets)
            if input_augment is not None:
                mel = input_augment(generator, mel)
        mel, targets, example_mask = shard_batch(mesh, time_sharded, mel, targets,
                                                 example_mask)
        optimizer.zero_grad(set_to_none=True)
        with _true_f32(model), attention_mesh(mesh, time_sharded):
            if accum_steps == 1:
                total, breakdown = forward_loss(mel, targets, example_mask)
                total.backward()
                total = total.detach()
            else:
                b = mel.shape[0]
                if b % accum_steps:
                    raise ValueError(f"batch {b} not divisible by accum_steps={accum_steps}")
                mb = b // accum_steps
                if example_mask is None:
                    shares = torch.full((accum_steps,), 1.0 / accum_steps, device=mel.device)
                else:
                    em = example_mask.float().reshape(accum_steps, mb)
                    shares = em.sum(dim=1) / em.sum().clamp_min(1e-8)
                total, breakdown = 0.0, {}
                for i in range(accum_steps):
                    rows = slice(i * mb, (i + 1) * mb)
                    t_i, bd_i = forward_loss(mel[rows], targets[rows], None
                                             if example_mask is None else example_mask[rows])
                    (shares[i] * t_i).backward()
                    total = total + shares[i] * t_i.detach()
                    for k, v in bd_i.items():
                        breakdown[k] = breakdown.get(k, 0.0) + shares[i] * v.detach()
        if mesh is not None:
            _sum_over_world(mesh, [p.grad for p in model.parameters() if p.grad is not None])
        optimizer.step()
        state.step += 1
        return state, _global_metrics(mesh, {"loss": total, **{k: v.detach() for k, v
                                                               in breakdown.items()}})

    return step


def _gather_grids(mesh, time_sharded: bool, grid: torch.Tensor) -> torch.Tensor:
    """Every rank's (B_local, T_local, ...) block of a decoded grid put back
    into the global (B, T, ...) grid, on every rank."""
    if mesh is None or mesh.world_size == 1:
        return grid
    blocks = [torch.empty_like(grid) for _ in range(mesh.world_size)]
    dist.all_gather(blocks, grid.contiguous(), group=mesh.world)
    n_t = mesh.n_model if time_sharded else 1
    rows = [torch.cat(blocks[d * mesh.n_model:d * mesh.n_model + n_t], dim=1)
            for d in range(mesh.n_data)]
    return torch.cat(rows, dim=0)


def make_metric_eval_step(model: nn.Module, loss_fn: SELDLossFn, num_classes: int,
                          bg_bias: float = 0.0, bias_sweep=None, mesh=None,
                          time_sharded: bool = False, accdoa_decoder=None,
                          accdoa_threshold: float = 0.5, threshold_sweep=None,
                          tta_decode=None):
    """An eval step that also decodes class grids, for checkpoint selection
    on a validation metric (train.select_metric) and for `evaluate_model`.

    Returns step(mel, label_mask, example_mask, loss_targets=None) ->
    (metrics, pred_cls, true_cls): the loss from the unbiased logits, the
    argmax class per cell of the logits (their background class reduced by
    bg_bias first) and the ground-truth class per cell decoded from the
    bitmask, both (B, T, G) int8 on the device. With bias_sweep (a list of
    floats) a fourth value follows: the (K, B, T, G) int8 grids decoded at
    each of those biases from the same forward, one at a time.

    For an ACCDOA model, accdoa_decoder(vectors, threshold) -> (B, T, G)
    int8 decodes the vectors (seld_tpu_torch.accdoa.grid_decoder with the
    grid bound) at accdoa_threshold in place of the argmax, threshold_sweep takes
    bias_sweep's place, and the loss is loss_fn(vectors, loss_targets,
    example_mask) on the raw vectors.

    tta_decode(mel) -> (pred_cls, swept grids or None) takes the decode's
    place: the grids of a test-time-augmented forward (evaluate_model's
    `tta_transforms`, one device), the loss still from the plain forward.

    With a `mesh` the step takes the global batch, runs this rank's block
    and returns the global metrics and grids: the argmax decode is per
    cell, so each rank decodes its block and the blocks are gathered."""
    _check_classes(loss_fn, num_classes)
    if accdoa_decoder is None:
        knob, sweep = bg_bias, bias_sweep

        def decode(logits, bias):
            if bias:
                logits = bias_background_logits(logits, bias)
            return torch.argmax(logits, dim=2).to(torch.int8)
    else:
        knob, sweep, decode = accdoa_threshold, threshold_sweep, accdoa_decoder

    @torch.no_grad()
    def step(mel, label_mask, example_mask, loss_targets=None):
        model.eval()
        targets = label_mask if loss_targets is None else loss_targets
        mel, label_mask, targets, example_mask = shard_batch(
            mesh, time_sharded, mel, label_mask, targets, example_mask)
        with attention_mesh(mesh, time_sharded):
            out = model(mel)
            total, breakdown = _loss(loss_fn, out, targets, example_mask)

        def gather(grid):
            return _gather_grids(mesh, time_sharded, grid)

        metrics = _global_metrics(mesh, {"loss": total, **breakdown})
        labels = _bit_labels(label_mask, num_classes).to(torch.int8)
        if tta_decode is not None:
            pred, swept = tta_decode(mel)
            return (metrics, pred, labels) + (() if swept is None else (swept,))
        result = (metrics, gather(decode(out, knob)), gather(labels))
        if sweep is not None:
            result += (torch.stack([gather(decode(out, k)) for k in sweep]),)
        return result

    return step


def make_eval_step(model: nn.Module, loss_fn: SELDLossFn, num_classes: int,
                   return_logits: bool = False, mesh=None, time_sharded: bool = False):
    """Returns step(mel, targets, example_mask) -> metrics (and the
    logits when return_logits): the eval-mode forward and the loss from the
    bitmask (or an ACCDOA loss's own targets), without gradients. With a
    `mesh` the step takes the global batch, runs this rank's block and
    returns the global metrics (and this rank's block of the logits)."""
    _check_classes(loss_fn, num_classes)

    @torch.no_grad()
    def step(mel, targets, example_mask):
        model.eval()
        mel, targets, example_mask = shard_batch(mesh, time_sharded, mel, targets,
                                                 example_mask)
        with attention_mesh(mesh, time_sharded):
            out = model(mel)
            total, breakdown = _loss(loss_fn, out, targets, example_mask)
        metrics = _global_metrics(mesh, {"loss": total, **breakdown})
        return (metrics, out) if return_logits else metrics

    return step
