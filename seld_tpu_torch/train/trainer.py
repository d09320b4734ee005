"""Training loop: the host-side orchestration around the train and eval
steps (counterpart: seld_tpu/train/trainer.py).

Adam with coupled L2, ReduceLROnPlateau on the test loss (or a per-step
warmup + cosine schedule), early stopping on the train loss, a best
checkpoint on the test loss (or on a DCASE2022 validation metric,
train.select_metric), a rolling checkpoint every N epochs, resume
from the newest rolling checkpoint, an optional parameter EMA,
quantization-aware training (train.qat: int8 fake-quant in the train
step, seld_tpu_torch.quant), knowledge distillation from a trained
teacher's checkpoint tree (train.distill_ckpt, seld_tpu_torch.distill), a
per-epoch record in metrics.jsonl, training_history.json and the
loss-curve PNG at the end, and every train.viz_loss_components_every
epochs a loss-component dashboard of the first test batch (seld_tpu_torch.viz),
and with train.profile_steps=N a torch.profiler trace of train steps 1..N.
The ACCDOA families (model.model_type accdoa_conformer /
multi_accdoa_conformer) train on the corpora's ACCDOA targets with the
ACCDOA or ADPIT loss, rotate those targets under ACS, and decode their
vectors at the 0.5 activity threshold for a validation metric.

Metrics stay on the device until the epoch's summary: one read-back per
epoch for the train metrics and one for the test metrics, none per step.

Checkpoints are written in the background (train/checkpoint.py): as the
JAX trainer does, training waits for the writes after a preemption save,
after a non-finite-loss save and at the end, and closes the manager on
the way out, an error's included. With model.param_dtype=bfloat16 the
parameters, Adam's moments (ChainAdam, train/optimizer.py) and the EMA
shadow are bf16; the CRNN with float32 compute and gradient accumulation
are refused with bf16 parameters before any corpus is built, where the
JAX package raises TypeError while tracing (check_param_dtype).

Under a process mesh (cfg.mesh; one process per GPU under torchrun) every
rank builds the same corpora, draws the same batches and runs the steps on
its block of each (see train/steps.py); every rank holds the whole state,
so a checkpoint is the same file as a one-device run's and loads in either.
Rank 0 alone writes checkpoints, metrics.jsonl and the history; the others
wait for it at a barrier, and every rank loads on resume.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import shutil
import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from seld_tpu_torch import resolve_device
from seld_tpu_torch.accdoa import ACCDOALossFn, ADPITLossFn, grid_decoder
from seld_tpu_torch.config import Config
from seld_tpu_torch.data.corpus import WindowedCorpus
from seld_tpu_torch.data.sampler import BatchIterator, device_prefetch, place_batch
from seld_tpu_torch.eval.metrics import DCASE2022_SUMMARY, dcase2022_metrics
from seld_tpu_torch.features.acs import make_acs_augment, make_acs_augment_accdoa
from seld_tpu_torch.features.spatial import feature_channels
from seld_tpu_torch.features.specaugment import make_spec_augment
from seld_tpu_torch.losses import SELDLossFn
from seld_tpu_torch.models import build_model
from seld_tpu_torch.models.registry import (
    ACCDOA_MODELS,
    CRNN_F32_BF16_PARAMS_ERROR,
    MULTI_ACCDOA_MODELS,
)
from seld_tpu_torch.parallel.mesh import Mesh, mesh_from_config
from seld_tpu_torch.parallel.multihost import launched_world_size
from seld_tpu_torch.parallel.sharding import check_divisible
from seld_tpu_torch.targets.rasterize import decode_class_bitmask
from seld_tpu_torch.train.checkpoint import CheckpointManager
from seld_tpu_torch.train.optimizer import (
    current_learning_rate,
    make_optimizer,
    rounded,
    set_learning_rate,
)
from seld_tpu_torch.train.schedule import EarlyStopping, ReduceLROnPlateau, WarmupCosine
from seld_tpu_torch.train.state import TrainState, create_train_state, param_count
from seld_tpu_torch.train.steps import (
    ACCUM_BF16_PARAMS_ERROR,
    DISTILL_MESH_ERROR,
    QAT_MESH_ERROR,
    make_eval_step,
    make_metric_eval_step,
    make_train_step,
)

logger = logging.getLogger(__name__)

# train.select_metric -> (dcase2022_metrics key, sign: +1 when lower is better)
SELECT_METRICS = {
    "seld_error": ("SELD_error", 1.0),
    "er": ("ER", 1.0),
    "f_macro": ("F_macro", -1.0),
}


class PreemptionGuard:
    """While installed, SIGTERM sets a flag that the epoch loop polls:
    training saves a rolling checkpoint and returns instead of dying
    mid-step, and a later run with resume=True continues from it."""

    def __init__(self):
        self.requested = False
        self._prev = None

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
        except ValueError:  # not the main thread: the flag is never set
            self._prev = None
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
        return False


class StepTrace:
    """train.profile_steps: a torch.profiler session (CPU activity, and CUDA
    activity on a CUDA device) over train steps 1..N of the first epoch, as
    seld_tpu/train/trainer.py:599-645 captures a JAX trace, written as a
    Chrome-trace JSON to <out_dir>/<YYYYmmdd_HHMMSS>_rank<r>.pt.trace.json
    (every rank of a mesh writes its own)."""

    def __init__(self, out_dir: Path, device: torch.device, rank: int):
        from torch.profiler import ProfilerActivity, profile

        self.out_dir, self.device, self.rank = Path(out_dir), device, rank
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        logger.info("profiler trace started -> %s", self.out_dir)

    def stop(self, steps: int) -> None:
        """End the session once the device is done and write the trace."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = self.out_dir / f"{stamp}_rank{self.rank}.pt.trace.json"
        self.prof.export_chrome_trace(str(path))
        logger.info("profiler trace captured (%d steps) -> %s", steps, path)


def _epoch_mean(metric_list: list[dict]) -> dict[str, float]:
    """Mean of the per-batch device scalars, in one read-back."""
    keys = list(metric_list[0])
    stacked = torch.stack([torch.stack([m[k].float() for m in metric_list]) for k in keys])
    return dict(zip(keys, stacked.mean(dim=1).tolist()))


def _replay_schedules(workdir, start_epoch: int, plateau, stopper):
    """Rebuild the plateau and early-stop state of a resumed run by
    replaying the completed epochs' metrics.jsonl records through them;
    without it the first plateau step after a resume would write a reduced
    learning rate back up. Of duplicate epoch numbers the last record
    counts. Returns the least replayed test loss, or None."""
    path = Path(workdir) / "metrics.jsonl"
    if not path.exists():
        return None
    by_epoch: dict[int, tuple[float, float]] = {}
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
            by_epoch[int(rec["epoch"])] = (
                float(rec["train"]["loss"]), float(rec["test"]["loss"]),
            )
        except (ValueError, KeyError, TypeError):
            continue  # a truncated or hand-edited line
    replayed = [e for e in sorted(by_epoch) if e < start_epoch]
    for e in replayed:
        train_loss, test_loss = by_epoch[e]
        plateau.step(test_loss)
        stopper.step(train_loss, e)
    if not replayed:
        return None
    logger.info(
        "Resume: replayed %d epoch records through the schedules (plateau lr %.6f, "
        "early-stop best %.6f @ epoch %d, %d epochs without improvement)",
        len(replayed), plateau.lr, stopper.best, stopper.best_epoch,
        stopper.epochs_without_improvement,
    )
    return min(by_epoch[e][1] for e in replayed)


def widest_halo(model_cfg) -> int:
    """Rows a time chunk lends each neighbour in the widest layer that
    spans time: the conformer blocks' depthwise convolution (kernel 31 in
    the flagship, model.conf_kernel_size in the Conformer)."""
    kernel = 31 if model_cfg.model_type == "resnet_conformer" else model_cfg.conf_kernel_size
    return max(kernel // 2, 1)


def check_param_dtype(cfg: Config) -> None:
    """Raise for the two bf16-parameter runs the JAX package cannot trace
    (a TypeError there), before any corpus is built."""
    mc = cfg.model
    if mc.param_dtype != "bfloat16":
        return
    if mc.model_type == "crnn" and mc.compute_dtype == "float32":
        raise ValueError(CRNN_F32_BF16_PARAMS_ERROR)
    if cfg.train.accum_steps > 1:
        raise ValueError(ACCUM_BF16_PARAMS_ERROR)


def ema_update(ema_params: list, live_params: list, decay: float) -> None:
    """One step of the parameter EMA, in place: seld_tpu/train/trainer.py:326's
    a * d + b * (1 - d), each scalar and product rounded to the parameters'
    dtype as XLA rounds it (in bf16 a decay of 0.999 rounds to 1.0, so the
    shadow moves only by the rounded live term)."""
    dtype = ema_params[0].dtype
    torch._foreach_mul_(ema_params, rounded(decay, dtype))
    torch._foreach_add_(ema_params, torch._foreach_mul(live_params, rounded(1.0 - decay, dtype)))


def check_mesh_config(cfg: Config, window_frames: int) -> None:
    """Raise for a run the mesh cannot shard, as the JAX trainer does,
    before any process group is joined."""
    mc = cfg.mesh
    if (cfg.model.model_type in ACCDOA_MODELS and mc.enable != "off"
            and launched_world_size() > 1):
        raise NotImplementedError(
            f"{cfg.model.model_type} under a process mesh of more than one rank is not "
            "ported (ROADMAP item 10's remainder)")
    if cfg.train.qat and mc.enable != "off" and launched_world_size() > 1:
        raise NotImplementedError(QAT_MESH_ERROR)
    if cfg.train.distill_ckpt and mc.enable != "off" and launched_world_size() > 1:
        raise NotImplementedError(DISTILL_MESH_ERROR)
    if (cfg.train.viz_loss_components_every > 0 and mc.enable != "off"
            and launched_world_size() > 1):
        raise NotImplementedError(
            "train.viz_loss_components_every under a process mesh of more than one rank is "
            "not ported (ROADMAP item 10's remainder)")
    if not mc.shard_time:
        return
    model_type = cfg.model.model_type
    if model_type == "crnn":
        raise ValueError(
            "mesh.shard_time is unsupported for the recurrent crnn (the GRU scans time "
            "sequentially); use conformer / resnet_conformer, or disable time sharding")
    if model_type not in ("conformer", "resnet_conformer"):
        raise NotImplementedError(
            f"mesh.shard_time for model_type={model_type!r} is not ported "
            "(ROADMAP item 10's remainder)")
    if window_frames % mc.model_axis:
        raise ValueError(
            f"mesh.shard_time: window_frames={window_frames} must divide by the model "
            f"mesh axis ({mc.model_axis}): pick a window length or mesh shape that "
            "divides evenly")
    halo = widest_halo(cfg.model)
    if mc.model_axis > 1 and window_frames // mc.model_axis < halo:
        raise ValueError(
            f"mesh.shard_time: chunks of {window_frames // mc.model_axis} frames "
            f"({window_frames} over {mc.model_axis}) are narrower than the widest halo "
            f"({halo} frames): use a longer window or a smaller model axis")


def _loss_dashboard(model, test_corpus: WindowedCorpus, cfg: Config, device: torch.device,
                    epoch: int) -> None:
    """Render the loss-component dashboard of the first test batch into
    <output>/train_visualizations. The eval-mode forward, the target decode
    and the choice of the frame (viz.visualize_loss_components' rule: the
    most non-background GT cells, the first such (batch, time)) run on
    `device` and raise; only that frame's logits and targets come to the
    host. Only the rendering is best-effort: a failure there logs a
    warning."""
    batch = next(iter(BatchIterator(test_corpus, cfg.train.batch_size, shuffle=False,
                                    prefetch=0)))
    m = cfg.grid.num_classes
    t0 = time.perf_counter()
    mel, mask = place_batch(batch, device)[:2]
    with torch.no_grad():
        model.eval()
        logits = model(mel)
    targets = decode_class_bitmask(mask, m, class_major=True)  # (B, T, M, G)
    counts = (targets.argmax(2) != m - 1).sum(-1)  # (B, T)
    b, t = divmod(int(counts.flatten().argmax()), counts.shape[1])
    frame_logits = logits[b, t].float().cpu().numpy()
    frame_targets = targets[b, t].cpu().numpy()
    logger.info("  Loss-component dashboard: forward and frame choice %.1f ms (epoch %d, "
                "batch %d, frame %d)", (time.perf_counter() - t0) * 1e3, epoch, b, t)
    t0 = time.perf_counter()
    try:
        from seld_tpu_torch.viz import draw_loss_components

        draw_loss_components(frame_logits, frame_targets, b, t, n_el=cfg.grid.n_el,
                             n_az=cfg.grid.n_az, epoch=epoch,
                             save_dir=Path(cfg.data.output_path) / "train_visualizations")
    except Exception as e:  # rendering is best-effort, never kills training
        logger.warning("  loss-component viz failed: %s", e)
        return
    logger.info("  Loss-component dashboard rendered in %.1f ms", (time.perf_counter() - t0) * 1e3)


def _barrier(mesh: Mesh | None) -> None:
    if mesh is not None:
        dist.barrier()


def train_model(cfg: Config, train_corpus: WindowedCorpus, test_corpus: WindowedCorpus,
                workdir: str | Path | None = None, resume: bool = False,
                device: str | torch.device | None = None):
    """Train per config on `device` (CUDA unless named); returns
    (state, history). The returned state holds the best weights when a
    best checkpoint was written."""
    device = resolve_device(device)
    workdir = Path(workdir if workdir is not None else cfg.data.checkpoint_path)
    workdir.mkdir(parents=True, exist_ok=True)
    tc = cfg.train
    if tc.lr_schedule not in ("plateau", "cosine"):
        raise ValueError(
            f"train.lr_schedule must be 'plateau' or 'cosine', got {tc.lr_schedule!r}"
        )
    select = tc.select_metric
    if select != "loss" and select not in SELECT_METRICS:
        raise ValueError(
            f"train.select_metric must be one of {['loss', *SELECT_METRICS]}, got {select!r}"
        )
    if tc.batch_size % tc.accum_steps:
        raise ValueError(
            f"train.batch_size={tc.batch_size} must divide by "
            f"train.accum_steps={tc.accum_steps}"
        )

    check_param_dtype(cfg)
    check_mesh_config(cfg, cfg.window.window_frames(cfg.features))
    accdoa_mode = cfg.model.model_type in ACCDOA_MODELS
    multi = cfg.model.model_type in MULTI_ACCDOA_MODELS
    if accdoa_mode and (train_corpus.accdoa is None or test_corpus.accdoa is None):
        raise ValueError(f"{cfg.model.model_type} trains on ACCDOA targets: build the "
                         "corpora with targets.accdoa=true")
    viz_every = tc.viz_loss_components_every
    if viz_every > 0 and accdoa_mode:
        logger.warning("train.viz_loss_components_every: the loss-component dashboard takes "
                       "grid logits, and %s emits vectors: no dashboard is rendered",
                       cfg.model.model_type)
        viz_every = 0
    input_augment = make_spec_augment(tc)
    spatial_augment = None
    if tc.acs_augment:
        # a named error unless the feature set carries signed direction
        # (mel_iv), raised before anything is built or cleared
        spatial_augment = (make_acs_augment_accdoa(cfg.features.feature_set, multi)
                           if accdoa_mode else
                           make_acs_augment(cfg.grid.n_el, cfg.grid.n_az,
                                            cfg.features.feature_set))

    mesh = mesh_from_config(cfg.mesh, device)
    time_sharded = mesh is not None and cfg.mesh.shard_time
    lead = mesh is None or mesh.rank == 0  # the rank that writes files
    if mesh is not None:
        check_divisible(mesh, tc.batch_size, train_corpus.window_frames if time_sharded
                        else None)
        logger.info("Process mesh %d x %d (data x model), rank %d; %s", mesh.n_data,
                    mesh.n_model, mesh.rank,
                    f"time axis sharded over the model axis ({mesh.n_model}-way)"
                    if time_sharded else "data parallel")
    model = build_model(cfg.model, cfg.grid, device=device, seed=tc.seed,
                        in_channels=feature_channels(cfg.features.feature_set,
                                                     cfg.model.n_channels))
    if accdoa_mode:
        loss_fn = ADPITLossFn() if multi else ACCDOALossFn()
    else:
        loss_fn = SELDLossFn(cfg.loss, cfg.grid)
    optimizer = make_optimizer(model.parameters(), tc.learning_rate, tc.weight_decay)
    state = create_train_state(model, optimizer)
    logger.info("Model %s: %s parameters on %s", cfg.model.model_type,
                f"{param_count(state):,}", device)
    logger.info(
        "Optimizer: Adam(lr=%g, L2 wd=%g); plateau factor=%g patience=%d; "
        "early stop patience=%d min_delta=%g",
        tc.learning_rate, tc.weight_decay, tc.lr_decay_factor, tc.lr_decay_patience,
        tc.patience, tc.min_delta,
    )

    distill = None
    if tc.distill_ckpt:
        from seld_tpu_torch.distill import load_teacher, teacher_variable_count

        if not 0.0 <= tc.distill_alpha <= 1.0:
            raise ValueError(f"train.distill_alpha must be in [0, 1], got {tc.distill_alpha}")
        if tc.distill_temperature <= 0.0:
            raise ValueError(
                f"train.distill_temperature must be > 0 (it divides the logits inside the "
                f"KD loss), got {tc.distill_temperature}")
        distill, t_meta = load_teacher(cfg, tc.distill_ckpt, device)
        logger.info(
            "Distillation: teacher %s (epoch %d, %s params) -> student %s; "
            "alpha=%g temperature=%g", distill.teacher.model_cfg.model_type,
            t_meta.get("epoch", -1), f"{teacher_variable_count(distill.teacher):,}",
            cfg.model.model_type, tc.distill_alpha, tc.distill_temperature)

    if not resume and lead:
        # a fresh run starts from a clean tree: stale checkpoints (possibly
        # of another architecture) must not be reloaded as "best", and
        # metrics.jsonl is appended to, so old records would poison a later
        # resume's schedule replay
        for sub in ("best", "rolling"):
            if (workdir / sub).exists():
                shutil.rmtree(workdir / sub)
                logger.info("Cleared previous %s checkpoints (fresh run)", sub)
        if (workdir / "metrics.jsonl").exists():
            (workdir / "metrics.jsonl").unlink()
            logger.info("Cleared previous metrics.jsonl (fresh run)")

    _barrier(mesh)
    ckpt = CheckpointManager(workdir, cfg)
    try:

        def save(kind, *args, **kwargs):
            """Rank 0 writes the checkpoint; the others wait for it."""
            if lead:
                getattr(ckpt, kind)(*args, **kwargs)
            _barrier(mesh)

        start_epoch = 1
        resume_best_meta = None
        resumed_lr = None
        if resume:
            # the best-so-far baseline comes from the best checkpoint even when
            # there is no rolling checkpoint to take the weights from
            resume_best_meta = ckpt.best_meta()
            restored = ckpt.restore_latest(state)
            if restored is not None:
                start_epoch = restored[1]["epoch"] + 1
                resumed_lr = current_learning_rate(optimizer)  # from the restored optimizer
                logger.info("Resumed from rolling checkpoint at epoch %d", restored[1]["epoch"])
            elif resume_best_meta is not None:
                logger.warning(
                    "Resume: no rolling checkpoint under %s: restarting training from "
                    "scratch, keeping the stored best checkpoint (epoch %d) as the "
                    "improvement baseline", workdir, resume_best_meta.get("epoch", -1),
                )

        # Parameter EMA: a shadow model updated after every step; it is what
        # eval sees and what the best checkpoint stores. Rolling checkpoints
        # keep the raw weights, and the EMA restarts from them on resume.
        ema_model = None
        if tc.ema_decay > 0:
            ema_model = copy.deepcopy(model).eval()
            ema_params, live_params = list(ema_model.parameters()), list(model.parameters())
            ema_buffers, live_buffers = list(ema_model.buffers()), list(model.buffers())
            logger.info("Parameter EMA on (decay %.4f); eval/best use EMA weights", tc.ema_decay)
        eval_model = model if ema_model is None else ema_model

        if input_augment is not None:
            logger.info("SpecAugment on: %d time masks (w<=%d frames), %d freq masks "
                        "(w<=%d bins)", tc.specaugment_time_masks, tc.specaugment_time_width,
                        tc.specaugment_freq_masks, tc.specaugment_freq_width)
        if spatial_augment is not None:
            logger.info("ACS spatial augmentation on: per-sample draw from the 16 FOA scene "
                        "transforms (features + %s)", "ACCDOA targets" if accdoa_mode else
                        "grid labels")
        if tc.accum_steps > 1:
            logger.info("Gradient accumulation: %d microbatches of %d",
                        tc.accum_steps, tc.batch_size // tc.accum_steps)
        if tc.qat:
            logger.info("Quantization-aware training: int8 fake-quant with straight-through "
                        "gradients on the PTQ layer set")
        train_step = make_train_step(model, loss_fn, optimizer, cfg.grid.num_classes,
                                     accum_steps=tc.accum_steps, input_augment=input_augment,
                                     spatial_augment=spatial_augment, mesh=mesh,
                                     time_sharded=time_sharded, qat=tc.qat, distill=distill)
        eval_step = make_eval_step(eval_model, loss_fn, cfg.grid.num_classes, mesh=mesh,
                                   time_sharded=time_sharded)
        # With a validation metric the eval pass also decodes predicted and true
        # class grids on the device, and the best checkpoint is chosen on the
        # DCASE2022 metric of the epoch instead of the test loss.
        metric_step = None
        if select != "loss":
            metric_step = make_metric_eval_step(
                eval_model, loss_fn, cfg.grid.num_classes, mesh=mesh, time_sharded=time_sharded,
                accdoa_decoder=(grid_decoder(multi, cfg.grid.n_el, cfg.grid.n_az,
                                             cfg.grid.num_classes) if accdoa_mode else None))
            logger.info("Best-checkpoint selection on DCASE2022 %s (computed every epoch "
                        "from decoded grids)", select)

        plateau = ReduceLROnPlateau(lr=tc.learning_rate, factor=tc.lr_decay_factor,
                                    patience=tc.lr_decay_patience)
        steps_per_epoch = max(-(-len(train_corpus) // tc.batch_size), 1)
        cosine = None
        if tc.lr_schedule == "cosine":
            cosine = WarmupCosine(peak=tc.learning_rate,
                                  total_steps=steps_per_epoch * tc.num_epochs,
                                  warmup_steps=tc.warmup_steps,
                                  final_scale=tc.cosine_final_scale)
            logger.info("LR schedule: warmup %d steps -> cosine over %d steps "
                        "(plateau rewrites disabled)", tc.warmup_steps, cosine.total_steps)
        stopper = EarlyStopping(patience=tc.patience, min_delta=tc.min_delta)
        replayed_min_test = None
        if start_epoch > 1:
            replayed_min_test = _replay_schedules(workdir, start_epoch, plateau, stopper)
            if resumed_lr is not None:
                plateau.lr = resumed_lr  # the restored optimizer is the ground truth

        train_iter = BatchIterator(train_corpus, tc.batch_size, shuffle=True,
                                   seed=cfg.data.shuffle_seed, prefetch=cfg.data.prefetch_depth)
        train_iter.epoch = start_epoch - 1  # a resumed run continues the shuffle sequence
        test_iter = BatchIterator(test_corpus, tc.batch_size, shuffle=False,
                                  prefetch=cfg.data.prefetch_depth)

        def place(batch):
            """(mel, loss targets, example mask, label mask): the loss targets
            are the bitmask, or an ACCDOA model's vectors."""
            mel, mask, em, *acc = place_batch(batch, device)
            return mel, acc[0] if accdoa_mode else mask, em, mask

        history = {"train_losses": [], "test_losses": [], "lr": []}
        if metric_step is not None:
            history["val_metric"] = []
        best_select = float("inf")
        best_test = float("inf")
        if resume_best_meta is not None:
            best_test = float(resume_best_meta.get("test_loss", float("inf")))
            if replayed_min_test is not None:
                # under a metric the best checkpoint's test loss is the
                # metric-best epoch's, not the least one seen
                best_test = min(best_test, replayed_min_test)
            logger.info("Resume: best test loss so far %.6f (best epoch %d)",
                        best_test, resume_best_meta.get("epoch", -1))
            if metric_step is not None:
                sel = resume_best_meta.get("select")
                if sel and sel.get("metric") == select:
                    best_select = SELECT_METRICS[select][1] * float(sel["value"])
                    history["best_val_metric"] = float(sel["value"])
                    history["best_val_epoch"] = int(resume_best_meta["epoch"])
                    logger.info("Resume: best %s so far %.4f", select, sel["value"])
                else:
                    logger.warning(
                        "Resume: the stored best checkpoint has no %s record (saved %s): the "
                        "first improvement after the resume sets the baseline anew",
                        select, (sel or {}).get("metric", "by test loss"),
                    )
        epoch = start_epoch - 1

        # JAX's window: started before step 1 of the first epoch, stopped after
        # the step numbered profile_steps, which is in a later epoch when the
        # first has fewer steps; a trace still open when training ends is
        # written then (the JAX package loses it)
        trace, traced = None, 0
        with PreemptionGuard() as preempt:
            for epoch in range(start_epoch, tc.num_epochs + 1):
                t0 = time.time()
                train_metrics = []
                for i, (mel, targets, em, _) in enumerate(
                    device_prefetch(train_iter, place, depth=cfg.data.prefetch_depth)
                ):
                    if tc.profile_steps > 0 and epoch == start_epoch and i == 1:
                        trace = StepTrace(Path(cfg.data.output_path) / "profile", device,
                                          0 if mesh is None else mesh.rank)
                    if cosine is not None:
                        set_learning_rate(optimizer, cosine((epoch - 1) * steps_per_epoch + i))
                    _, metrics = train_step(state, mel, targets, em, (tc.seed, epoch))
                    traced += trace is not None
                    if ema_model is not None:
                        with torch.no_grad():  # the shadow keeps the live BatchNorm statistics
                            ema_update(ema_params, live_params, tc.ema_decay)
                            torch._foreach_copy_(ema_buffers, live_buffers)
                    train_metrics.append(metrics)
                    if trace is not None and (preempt.requested or i == tc.profile_steps):
                        trace.stop(traced)  # a preemption finishes an open trace too
                        trace = None
                    if preempt.requested:  # a host flag: no device sync
                        break
                train_avg = _epoch_mean(train_metrics)
                if epoch == start_epoch and device.type == "cuda":
                    logger.info("Peak device memory after the first epoch: %.2f GiB",
                                torch.cuda.max_memory_allocated(device) / 2**30)

                if preempt.requested:
                    logger.warning("SIGTERM received: saving a preemption checkpoint at "
                                   "epoch %d and exiting cleanly", epoch)
                    save("save_rolling", epoch, state, train_avg["loss"], float("inf"))
                    ckpt.wait()
                    history["preempted_epoch"] = epoch
                    break

                if not math.isfinite(train_avg["loss"]):
                    logger.error("Non-finite train loss %.6f at epoch %d: saving an "
                                 "emergency checkpoint and aborting", train_avg["loss"], epoch)
                    save("save_rolling", epoch, state, train_avg["loss"], float("inf"))
                    ckpt.wait()
                    history["aborted_epoch"] = epoch
                    break

                val22 = None
                if metric_step is None:
                    eval_metrics = [
                        eval_step(mel, targets, em)
                        for mel, targets, em, _ in device_prefetch(test_iter, place,
                                                                   depth=cfg.data.prefetch_depth)
                    ]
                else:
                    eval_metrics, preds, trues = [], [], []
                    for mel, targets, em, mask in device_prefetch(test_iter, place,
                                                                  depth=cfg.data.prefetch_depth):
                        m, p, t = metric_step(mel, mask, em, targets)
                        eval_metrics.append(m)
                        n_valid = int(em.sum().item())  # the padded tail's rows drop out
                        preds.append(p[:n_valid].cpu().numpy())
                        trues.append(t[:n_valid].cpu().numpy())
                    val22 = dcase2022_metrics(np.concatenate(preds), np.concatenate(trues),
                                              cfg.grid.n_el, cfg.grid.n_az, cfg.grid.num_classes)
                test_avg = _epoch_mean(eval_metrics)

                if cosine is not None:
                    new_lr = current_learning_rate(optimizer)
                else:
                    new_lr = plateau.step(test_avg["loss"])
                    old_lr = current_learning_rate(optimizer)
                    # rewrite only on a real change (reductions are x0.5), not on
                    # the rounding of a stored and restored value
                    if abs(new_lr - old_lr) > 1e-6 * max(abs(new_lr), abs(old_lr), 1e-30):
                        set_learning_rate(optimizer, new_lr)
                        logger.info("  Learning rate reduced: %.6f -> %.6f", old_lr, new_lr)

                history["train_losses"].append(train_avg["loss"])
                history["test_losses"].append(test_avg["loss"])
                history["lr"].append(new_lr)
                record = {"epoch": epoch, "seconds": round(time.time() - t0, 2), "lr": new_lr,
                          "train": train_avg, "test": test_avg}
                if val22 is not None:
                    record["val_dcase2022"] = {k: float(val22[k]) for k in DCASE2022_SUMMARY}
                if lead:
                    with (workdir / "metrics.jsonl").open("a") as fh:
                        fh.write(json.dumps(record) + "\n")
                logger.info("Epoch %d/%d - %.1fs | train %.6f | test %.6f | lr %.6f",
                            epoch, tc.num_epochs, time.time() - t0,
                            train_avg["loss"], test_avg["loss"], new_lr)
                for k in train_avg:
                    if k == "loss":
                        continue
                    if k in test_avg:
                        logger.info("    %s: train %.6f test %.6f", k, train_avg[k], test_avg[k])
                    else:  # train-only terms (the distillation's kd / hard split)
                        logger.info("    %s: train %.6f", k, train_avg[k])

                best_state = state if ema_model is None else TrainState(state.step, ema_model, None)
                if metric_step is None:
                    if test_avg["loss"] < best_test - tc.min_delta:
                        best_test = test_avg["loss"]
                        save("save_best", epoch, best_state, train_avg["loss"], test_avg["loss"])
                        logger.info("  New best model saved (test loss %.6f)", best_test)
                else:
                    key, sign = SELECT_METRICS[select]
                    val = float(val22[key])
                    logger.info("  DCASE2022 val: ER %.3f F %.3f LE %.1f deg LR %.3f | "
                                "SELD_error %.3f", *(val22[k] for k in DCASE2022_SUMMARY))
                    history["val_metric"].append(val)
                    best_test = min(best_test, test_avg["loss"])
                    if sign * val < best_select:
                        best_select = sign * val
                        history["best_val_metric"] = val
                        history["best_val_epoch"] = epoch
                        save("save_best", epoch, best_state, train_avg["loss"], test_avg["loss"],
                             select={"metric": select, "value": val})
                        logger.info("  New best model saved (%s %.4f)", select, val)
                if epoch % tc.save_every_n_epochs == 0:
                    save("save_rolling", epoch, state, train_avg["loss"], test_avg["loss"])
                    logger.info("  Rolling checkpoint saved (epoch %d)", epoch)
                if viz_every > 0 and epoch % viz_every == 0:
                    _loss_dashboard(eval_model, test_corpus, cfg, device, epoch)

                if stopper.step(train_avg["loss"], epoch):
                    logger.info(
                        "EARLY STOPPING at epoch %d (no train improvement for %d epochs; "
                        "best train %.6f @ epoch %d)",
                        epoch, stopper.patience, stopper.best, stopper.best_epoch,
                    )
                    break

        ckpt.wait()  # rank 0's files on disk before any rank restores the best
        _barrier(mesh)
        if trace is not None:
            logger.warning("profiler trace still open when training ended (no later epoch "
                           "reached step %d): writing the %d train steps it holds",
                           tc.profile_steps, traced)
            trace.stop(traced)
        history.update(best_train_loss=stopper.best, best_test_loss=best_test,
                       best_epoch=stopper.best_epoch, total_epochs=epoch)
        if lead:
            try:
                from seld_tpu_torch.viz import plot_loss_curves

                out_dir = Path(cfg.data.output_path)
                out_dir.mkdir(parents=True, exist_ok=True)
                plot_loss_curves(history["train_losses"], history["test_losses"],
                                 save_path=out_dir / "loss_curves.png")
            except Exception as e:  # rendering is best-effort, never kills training
                logger.warning("loss-curve plot failed: %s", e)
        restored = ckpt.restore_best(state)
        if restored is not None:
            logger.info("Best model loaded from epoch %d", restored[1]["epoch"])
        hist_path = workdir / "training_history.json"
        if lead:
            hist_path.write_text(json.dumps(history, indent=2))
            logger.info("Training history saved to %s", hist_path)
        return state, history
    finally:
        ckpt.close()  # every rank, an error's exit included
