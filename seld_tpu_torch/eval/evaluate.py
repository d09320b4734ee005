"""Model evaluation (counterpart: seld_tpu/eval/evaluate.py::evaluate_model).

  * the architecture is rebuilt from the config stored in the checkpoint,
    not from the live one;
  * the device returns int8 class grids and scalar losses per batch, never
    the logits: grid models decode by argmax (after an optional background
    bias), the ACCDOA families by their activity threshold, every sweep
    candidate from the one forward per batch;
  * the report carries the cell accuracies, the frame-level SELD variant
    ("dcase") and the official DCASE2022 metrics ("dcase2022"), under the
    JAX package's keys.

With `tta_transforms` the decodes, and so every metric and sweep, come
from the ACS test-time-augmented forward (seld_tpu_torch.tta); the
losses stay on the plain forward. With `int8` the model is the int8
post-training-quantized one (seld_tpu_torch.quant), calibrated on the
first batches of the corpus, for the losses and the decodes alike. Left to
its own slice of the port, and therefore no parameter here: a device mesh.

With `save_visualizations` a second pass renders GT / prediction /
agreement PNGs (seld_tpu_torch.viz) of frames with events, chosen as the
JAX package chooses them, from one more forward of just their windows.
"""

from __future__ import annotations

import logging
import random
import time
from pathlib import Path

import numpy as np
import torch

from seld_tpu_torch import resolve_device
from seld_tpu_torch.accdoa import (
    ACCDOALossFn,
    ADPITLossFn,
    decode_accdoa_to_grid,
    decode_vote_grid,
    grid_decoder,
)
from seld_tpu_torch.config import Config
from seld_tpu_torch.data.corpus import WindowedCorpus
from seld_tpu_torch.data.sampler import BatchIterator, place_batch
from seld_tpu_torch.eval.metrics import (
    DCASE2022_SUMMARY,
    accuracy_metrics,
    dcase2022_metrics,
    seld_metrics,
)
from seld_tpu_torch.features.spatial import feature_channels
from seld_tpu_torch.infer import bias_background_logits, validate_accdoa_threshold
from seld_tpu_torch.losses import SELDLossFn
from seld_tpu_torch.models import build_model
from seld_tpu_torch.models.registry import ACCDOA_MODELS, MULTI_ACCDOA_MODELS
from seld_tpu_torch.parallel.sequence import current_mesh
from seld_tpu_torch.postprocess import smooth_classes, validate_width
from seld_tpu_torch.quant import QuantizedModel, quantize_model
from seld_tpu_torch.targets.rasterize import bitmask_to_dense
from seld_tpu_torch.train.checkpoint import checkpoint_file, load_checkpoint_config
from seld_tpu_torch.train.completion import workdir_incomplete_reason
from seld_tpu_torch.train.steps import make_metric_eval_step
from seld_tpu_torch.tta import make_tta_forward, validate_transforms

logger = logging.getLogger(__name__)


def _sweep_report(name: str, flag: str, values, key_of, grids_of, true_classes, grid,
                  num_classes: int) -> dict:
    """DCASE2022 rows for each candidate of a decode knob, and the
    candidate with the least SELD_error."""
    report = {"metrics": {}}
    for value in values:
        m = dcase2022_metrics(grids_of(value), true_classes, grid.n_el, grid.n_az, num_classes)
        row = {key: float(m[key]) for key in DCASE2022_SUMMARY}
        report["metrics"][key_of(value)] = row
        logger.info("  %s %s: ER %.3f F %.3f LE %.1f deg LR %.3f | SELD_error %.3f",
                    name, key_of(value), *(row[k] for k in DCASE2022_SUMMARY))
    best = min(values, key=lambda value: report["metrics"][key_of(value)]["SELD_error"])
    report["best"] = {name: best, **report["metrics"][key_of(best)]}
    logger.info("  -> best %s %s (SELD_error %.3f); serve with `predict %s %g`",
                name, key_of(best), report["best"]["SELD_error"], flag, best)
    return report


def _tta_decode(model, kind: str, grid, feature_set: str, transforms, bg_bias: float,
                bias_sweep, acc_th: float, threshold_sweep):
    """The decode of an eval batch under test-time augmentation: mel ->
    (pred (B, T, G) int8, the (K, B, T, G) int8 grids of the sweep or None),
    each from the TTA average of its kind. A sweep candidate that enters
    each view (a grid bias before the softmax, a multi-ACCDOA threshold
    before the vote) is swept inside the TTA forward, with the main decode's
    value as its last row, so the views run once; single-ACCDOA candidates
    threshold the averaged vectors."""
    common = dict(n_el=grid.n_el, n_az=grid.n_az, feature_set=feature_set,
                  transforms=transforms, kind=kind)

    def grids(x, axis):
        return torch.argmax(x, dim=axis).to(torch.int8)

    if kind == "grid" and bias_sweep is not None:
        fwd = make_tta_forward(model, bias_sweep=[*bias_sweep, bg_bias], **common)

        def decode(mel):
            probs = fwd(mel)
            return grids(probs[-1], 2), grids(probs[:-1], 3)
    elif kind == "grid":
        fwd = make_tta_forward(
            lambda m: bias_background_logits(model(m), bg_bias) if bg_bias else model(m),
            **common)

        def decode(mel):
            return grids(fwd(mel), 2), None
    elif kind == "multi_accdoa":
        fwd = make_tta_forward(model, activity_threshold=acc_th,
                               threshold_sweep=(None if threshold_sweep is None
                                                else [*threshold_sweep, acc_th]), **common)

        def decode(mel):
            votes = decode_vote_grid(fwd(mel), grid.num_classes)
            return (votes, None) if threshold_sweep is None else (votes[-1], votes[:-1])
    else:
        fwd = make_tta_forward(model, **common)

        def decode(mel):
            vectors = fwd(mel)
            pred = decode_accdoa_to_grid(vectors, grid.n_el, grid.n_az, grid.num_classes, acc_th)
            if threshold_sweep is None:
                return pred, None
            return pred, torch.stack([decode_accdoa_to_grid(
                vectors, grid.n_el, grid.n_az, grid.num_classes, th) for th in threshold_sweep])
    return decode


def _visualize(model, test_corpus: WindowedCorpus, chosen: list[dict], output_path: Path,
               grid, device: torch.device, bg_bias: float, accdoa_decode) -> list[dict]:
    """The second pass: one eval-mode forward of the sorted set of windows
    of the chosen frames, and a PNG per frame of its ground truth against
    the decode rule's view of the output: the logits with bg_bias applied,
    or an ACCDOA model's grid decode (accdoa_decode) as one-hot class maps.
    Only the chosen frames come back to the host. Returns the chosen
    frames' records with their save_path."""
    from seld_tpu_torch.viz import visualize_grid_predictions

    num_classes = grid.num_classes
    viz_dir = output_path / "test_visualizations"
    viz_dir.mkdir(parents=True, exist_ok=True)
    windows = sorted({d["window_idx"] for d in chosen})
    row_of = {w: i for i, w in enumerate(windows)}
    rows = np.asarray([row_of[d["window_idx"]] for d in chosen])
    times = np.asarray([d["time_idx"] for d in chosen])
    mel, mask = test_corpus.gather(np.asarray(windows))
    t0 = time.perf_counter()
    with torch.no_grad():
        model.eval()
        out = model(torch.from_numpy(np.ascontiguousarray(mel)).to(device))
        at = (torch.from_numpy(rows).to(device), torch.from_numpy(times).to(device))
        if accdoa_decode is not None:
            cls = accdoa_decode(out)[at].long().cpu().numpy()  # (K, G)
            # class-major one-hot (K, M, G)
            preds = np.moveaxis(np.eye(num_classes, dtype=np.float32)[cls], -1, 1)
        else:
            logits = bias_background_logits(out, bg_bias) if bg_bias else out
            preds = logits[at].float().cpu().numpy()  # class-major (K, M, G)
    forward_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    dense = np.moveaxis(bitmask_to_dense(mask[rows, times], num_classes), -1, -2)  # (K, M, G)
    records = []
    for k, d in enumerate(chosen):
        t = d["time_idx"]
        save_path = viz_dir / f"test_viz_{k + 1}_window{d['window_idx']}_frame{t}.png"
        visualize_grid_predictions(
            dense[k], preds[k], time_frame=t, grid_size=(grid.n_el, grid.n_az),
            num_classes=num_classes, title_prefix=f"Window {d['window_idx']}, ",
            save_path=save_path)
        records.append({**d, "save_path": str(save_path)})
    logger.info("Saved %d prediction visualizations to %s (forward of %d windows %.1f ms, "
                "rendering %.1f ms)", len(records), viz_dir, len(windows), forward_ms,
                (time.perf_counter() - t0) * 1e3)
    return records


def evaluate_model(
    cfg: Config,
    test_corpus: WindowedCorpus,
    checkpoint_dir,
    num_visualizations: int = 5,
    save_visualizations: bool = True,
    seed: int = 0,
    bg_bias: float = 0.0,
    bg_bias_sweep=None,
    accdoa_threshold: float | None = None,
    accdoa_threshold_sweep=None,
    median_filter: int = 0,
    median_filter_sweep=None,
    use_checkpoint: str = "best",
    device: str | torch.device | None = None,
    tta_transforms=None,
    int8: bool = False,
    int8_weight_only: bool = False,
    int8_calib_batches: int = 4,
) -> dict:
    """Score the checkpoint tree under `checkpoint_dir` on `test_corpus`,
    on `device` (CUDA unless named).

    use_checkpoint: "best" scores the best checkpoint, "latest" the newest
    rolling one (the raw final weights); when the asked-for kind is absent
    the other is taken, with a warning, and the report's "checkpoint_kind"
    says which was scored.

    bg_bias: reduce the background class's logit by this amount before
    every decode, the detection operating point of
    `SELDPredictor(bg_bias=...)`; losses stay on the unbiased logits.
    bg_bias_sweep (floats): every bias decoded on the device from the one
    forward per batch; the report gains a DCASE2022 row per bias and the
    bias with the least SELD_error. Grid models only: on an ACCDOA model
    either is a ValueError.

    accdoa_threshold (ACCDOA families): the vector-norm activity threshold
    of every decode (None: 0.5), the operating point of
    `SELDPredictor(accdoa_threshold=...)`; losses stay on the raw vectors.
    accdoa_threshold_sweep (floats): every threshold decoded on the device
    from the one forward per batch, with a DCASE2022 row per threshold and
    the one with the least SELD_error. On a grid model either is a
    ValueError.

    median_filter (odd frames): majority smoothing of each window's
    decoded grid before the metrics, the eval gate of
    `predict --median-filter`. median_filter_sweep (odd widths): the
    filter runs on the host on the gathered grids, so widths cost no
    forward; the report gains a row per width and the best one. The
    bg_bias_sweep rows stay unfiltered.

    tta_transforms: an ACS transform subset (seld_tpu_torch.tta; "mel_iv"
    features only): every decode, and so every metric, comes from the
    TTA-averaged forward (mean probabilities, mean vectors or votes), and
    each sweep calibrates that decode; the losses stay on the plain
    forward, comparable across runs.

    num_visualizations, save_visualizations, seed: with save_visualizations
    and num_visualizations > 0, random.Random(seed) samples that many of the
    frames with events (in np.nonzero order over the true class grids), and
    one eval-mode forward of their windows on `device` renders each as
    <output_path>/test_visualizations/test_viz_{k}_window{w}_frame{t}.png;
    the report's "visualizations" lists their window_idx, time_idx,
    num_active and save_path. That forward is the model the report scores
    (the int8 one under int8), never the TTA one, with bg_bias applied
    before the argmax; an ACCDOA model's vectors are decoded at the
    activity threshold and drawn as one-hot class maps. It is a forward of
    its own batch, so at a cell where two classes nearly tie its grid can
    differ from the first pass's (a row's output on the card depends on its
    batch slot), as the JAX package's second pass, a jitted call of its
    own, can.

    int8: evaluate the int8 post-training-quantized forward (the accuracy
    gate of `predict --int8` and of int8 artifacts), its activation scales
    calibrated on the first int8_calib_batches batches of train.batch_size
    windows of test_corpus; int8_weight_only quantizes the weights only. The
    losses (K2's forward on the card), the decodes and TTA all run it. Not
    under a device mesh: the quantized forward runs on one device."""
    device = resolve_device(device)
    if int8 and current_mesh()[0] is not None:
        raise ValueError("eval --int8 does not compose with a device mesh — the quantized "
                         "forward runs single-device, like the predictor")
    if int8_weight_only and not int8:
        raise ValueError("int8_weight_only requires int8")
    if use_checkpoint not in ("best", "latest"):
        raise ValueError(f"use_checkpoint must be 'best' or 'latest', got {use_checkpoint!r}")
    median_filter = validate_width(median_filter)
    if median_filter_sweep is not None:
        median_filter_sweep = [validate_width(w) for w in median_filter_sweep]
        if not median_filter_sweep:
            raise ValueError("median_filter_sweep must list at least one width")
    if bg_bias_sweep is not None:
        bg_bias_sweep = [float(b) for b in bg_bias_sweep]
        if not bg_bias_sweep:
            raise ValueError("bg_bias_sweep must list at least one bias")

    # a preempted or aborted run leaves a checkpoint tree that looks whole
    training_incomplete = workdir_incomplete_reason(checkpoint_dir)
    if training_incomplete is not None:
        logger.warning("checkpoint %s comes from truncated training (%s): the metrics are "
                       "those of a partially trained model", checkpoint_dir, training_incomplete)
    stored_cfg = load_checkpoint_config(checkpoint_dir)
    # the stem's width follows the feature set the checkpoint was trained on
    in_channels = feature_channels((stored_cfg or cfg).features.feature_set,
                                   cfg.model.n_channels)
    if test_corpus.mel.shape[1] != in_channels:
        raise ValueError(
            f"the test corpus has {test_corpus.mel.shape[1]} feature channels, the "
            f"checkpoint's model takes {in_channels} (features.feature_set="
            f"{(stored_cfg or cfg).features.feature_set!r})"
        )
    if stored_cfg is not None:
        if stored_cfg.model != cfg.model:
            logger.warning("checkpoint architecture (%s) differs from the live config (%s); "
                           "using the checkpoint's", stored_cfg.model, cfg.model)
        cfg = cfg.replace_path("model", stored_cfg.model)
    accdoa_mode = cfg.model.model_type in ACCDOA_MODELS
    if accdoa_mode and (bg_bias or bg_bias_sweep is not None):
        raise ValueError("bg_bias applies to grid models only — ACCDOA decodes have no "
                         "background logit")
    acc_th = validate_accdoa_threshold(accdoa_threshold, accdoa_mode)
    if accdoa_threshold_sweep is not None:
        accdoa_threshold_sweep = [validate_accdoa_threshold(t, accdoa_mode)
                                  for t in accdoa_threshold_sweep]
        if not accdoa_threshold_sweep:
            raise ValueError("accdoa_threshold_sweep must list at least one threshold")
    if accdoa_mode and test_corpus.accdoa is None:
        raise ValueError(f"evaluating {cfg.model.model_type} needs a test corpus built with "
                         "targets.accdoa=true")

    checkpoint_kind = use_checkpoint
    path = checkpoint_file(checkpoint_dir, use_checkpoint)
    if path is None:
        checkpoint_kind = "latest" if use_checkpoint == "best" else "best"
        path = checkpoint_file(checkpoint_dir, checkpoint_kind)
        if path is not None:
            # "latest" falling back to the best file can mean EMA weights
            # where the caller expected the raw final ones: never silent
            logger.warning("No %s checkpoint under %s: falling back to the %s one",
                           use_checkpoint, checkpoint_dir, checkpoint_kind)
    if path is None:
        raise FileNotFoundError(f"no checkpoint found under {checkpoint_dir}")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    meta = blob["meta"]
    model = build_model(cfg.model, cfg.grid, device=device, seed=None,
                        in_channels=in_channels)
    model.load_state_dict(blob["state_dict"])
    logger.info("Loaded checkpoint epoch %d (test loss %.6f) on %s",
                meta["epoch"], meta["test_loss"], device)

    if int8:
        bs = cfg.train.batch_size
        calib = [test_corpus.gather(np.arange(start, min(start + bs, len(test_corpus))))[0]
                 for start in range(0, min(int8_calib_batches * bs, len(test_corpus)), bs)]
        tree = quantize_model(model, calib, weight_only=int8_weight_only)
        model = QuantizedModel(model, tree)
        logger.info("Eval int8 PTQ: %d quantized layers, %d calibration batches%s", len(tree),
                    len(calib), ", weight-only" if int8_weight_only else "")

    grid, num_classes = cfg.grid, cfg.grid.num_classes
    multi = cfg.model.model_type in MULTI_ACCDOA_MODELS
    tta_decode = None
    if tta_transforms is not None:
        tta_transforms = validate_transforms(tta_transforms)
        tta_decode = _tta_decode(
            model, "multi_accdoa" if multi else "accdoa" if accdoa_mode else "grid", grid,
            (stored_cfg or cfg).features.feature_set, tta_transforms, float(bg_bias),
            bg_bias_sweep, acc_th, accdoa_threshold_sweep)
        logger.info("Eval TTA enabled (%d transforms)", len(tta_transforms))
    if accdoa_mode:
        step = make_metric_eval_step(
            model, ADPITLossFn() if multi else ACCDOALossFn(), num_classes,
            accdoa_decoder=grid_decoder(multi, grid.n_el, grid.n_az, num_classes),
            accdoa_threshold=acc_th, threshold_sweep=accdoa_threshold_sweep,
            tta_decode=tta_decode)
    else:
        step = make_metric_eval_step(model, SELDLossFn(cfg.loss, grid), num_classes,
                                     bg_bias=float(bg_bias), bias_sweep=bg_bias_sweep,
                                     tta_decode=tta_decode)
    losses, preds, trues, sweep_rows = [], [], [], []
    for batch in BatchIterator(test_corpus, cfg.train.batch_size, shuffle=False, prefetch=2):
        mel, mask, em, *acc = place_batch(batch, device)
        metrics, pred, true, *swept = step(mel, mask, em, acc[0] if accdoa_mode else None)
        losses.append(metrics)
        preds.append(pred[:batch.n_valid].cpu().numpy())
        trues.append(true[:batch.n_valid].cpu().numpy())
        if swept:
            sweep_rows.append(swept[0][:, :batch.n_valid].cpu().numpy())
    avg = {k: float(np.mean([float(m[k]) for m in losses])) for k in losses[0]}
    raw_pred_classes = pred_classes = np.concatenate(preds, axis=0)  # (N, T, G) int8
    true_classes = np.concatenate(trues, axis=0)

    if median_filter > 1:
        pred_classes = smooth_classes(pred_classes, median_filter, num_classes)
        logger.info("Median filter (majority, %d frames) applied to the prediction grids",
                    median_filter)
    acc = accuracy_metrics(pred_classes, true_classes, grid.background_class)
    dcase = seld_metrics(pred_classes, true_classes, grid.n_el, grid.n_az, num_classes)
    dcase22 = dcase2022_metrics(pred_classes, true_classes, grid.n_el, grid.n_az, num_classes)
    logger.info("Test loss %.6f", avg["loss"])
    logger.info("Overall acc %.2f%% | non-bg acc %.2f%% | active %d/%d",
                acc["overall_accuracy"], acc["non_bg_accuracy"],
                acc["active_events"], acc["total_cells"])
    logger.info("SELD (frame variant): ER %.3f F %.3f LE %.1f deg LR %.3f",
                dcase["ER"], dcase["F"], dcase["LE"], dcase["LR"])
    logger.info("DCASE2022 (official, 1 s segments): ER %.3f F %.3f LE_CD %.1f deg "
                "LR_CD %.3f | SELD_error %.3f", *(dcase22[k] for k in DCASE2022_SUMMARY))
    logger.info("  macro over GT classes only: F %.3f LE_CD %.1f deg LR_CD %.3f | "
                "SELD_error %.3f", dcase22["macro_gt"]["F"], dcase22["macro_gt"]["LE"],
                dcase22["macro_gt"]["LR"], dcase22["macro_gt"]["SELD_error"])
    cw = dcase22["classwise"]
    for c, nref in enumerate(cw["Nref"]):
        if nref > 0:
            logger.info("  class %2d F %.3f LE %6.1f deg LR %.3f (Nref %d)",
                        c, cw["F"][c], cw["LE"][c], cw["LR"][c], nref)

    knob_report = None
    knob, flag, values = (("accdoa_threshold", "--accdoa-threshold", accdoa_threshold_sweep)
                          if accdoa_mode else ("bg_bias", "--bg-bias", bg_bias_sweep))
    if values is not None:
        # keys are repr(float): near-identical candidates keep their own rows
        swept = {repr(v): np.concatenate([rows[k] for rows in sweep_rows], axis=0)
                 for k, v in enumerate(values)}
        knob_report = _sweep_report(knob, flag, values, repr, lambda v: swept[repr(v)],
                                    true_classes, grid, num_classes)
    mf_report = None
    if median_filter_sweep is not None:
        mf_report = _sweep_report(
            "median_filter", "--median-filter", median_filter_sweep, str,
            lambda w: (raw_pred_classes if w <= 1
                       else smooth_classes(raw_pred_classes, w, num_classes)),
            true_classes, grid, num_classes)

    active_per_frame = (true_classes != grid.background_class).sum(-1)  # (N, T)
    frames_with_events = [
        {"window_idx": int(w), "time_idx": int(t), "num_active": int(active_per_frame[w, t])}
        for w, t in zip(*np.nonzero(active_per_frame))]
    logger.info("Found %d frames with active events", len(frames_with_events))
    viz_records = []
    if save_visualizations and frames_with_events and num_visualizations > 0:
        chosen = random.Random(seed).sample(
            frames_with_events, min(num_visualizations, len(frames_with_events)))
        chosen.sort(key=lambda d: d["num_active"], reverse=True)
        decode = (None if not accdoa_mode else
                  lambda out: grid_decoder(multi, grid.n_el, grid.n_az, num_classes)(out, acc_th))
        viz_records = _visualize(model, test_corpus, chosen, Path(cfg.data.output_path), grid,
                                 device, float(bg_bias), decode)
    return {
        "test_loss": avg["loss"],
        **{k: v for k, v in avg.items() if k != "loss"},
        **acc,
        "dcase": dcase,
        "dcase2022": dcase22,
        "num_frames_with_events": len(frames_with_events),
        "visualizations": viz_records,
        "checkpoint_epoch": meta["epoch"],
        "checkpoint_kind": checkpoint_kind,
        "quantized_int8": bool(int8),
        "bg_bias": float(bg_bias),
        **({"accdoa_threshold": acc_th} if accdoa_mode else {}),
        **({f"{knob}_sweep": knob_report} if knob_report else {}),
        "median_filter": int(median_filter),
        **({"median_filter_sweep": mf_report} if mf_report else {}),
        **({"training_incomplete": training_incomplete} if training_incomplete else {}),
    }
