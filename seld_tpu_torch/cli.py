"""Command line (counterpart: seld_tpu/cli.py `train`, `eval`, `verify`,
`predict`, `calibrate`, `score`, `average-ckpts`, `export` and `serve`).

    python -m seld_tpu_torch.cli train [--synthetic] [--resume] [--eval-after] \
        [--num-visualizations N] [--device cpu] [k.e.y=value ...]

trains per config (every config field is a dotted key=value override, e.g.
data.base_path=RUN train.num_epochs=2) and writes best/ and rolling/
checkpoints, metrics.jsonl and training_history.json under
<data.base_path>/checkpoints, and <data.base_path>/outputs/loss_curves.png
(with train.viz_loss_components_every=K also a loss-component dashboard
every K epochs under outputs/train_visualizations); --eval-after then
scores the result as `eval` does. Over several processes, one GPU each:

    torchrun --standalone --nproc-per-node N -m seld_tpu_torch.cli train \
        mesh.enable=on mesh.model_axis=M mesh.shard_time=true [k.e.y=value ...]

runs a (N / M) x M mesh, the window's time axis split over the M ranks of
each model group (sequence parallelism, ring attention K5); without
shard_time (M = 1) it is data parallel. Each process uses cuda:LOCAL_RANK
and NCCL (one GPU per rank); --device cpu uses gloo. Rank 0 writes the
files.

An ACCDOA model (model.model_type=accdoa_conformer or
multi_accdoa_conformer) switches targets.accdoa on, and multi-ACCDOA
targets.accdoa_tracks to 3.

    python -m seld_tpu_torch.cli eval [--synthetic] [--bg-bias B] \
        [--bg-bias-sweep B1,B2] [--accdoa-threshold T] [--accdoa-threshold-sweep T1,T2] \
        [--median-filter W] [--median-filter-sweep W1,W2] [--calibration FILE] \
        [--tta] [--tta-transforms 0,4] [--int8 [--int8-weight-only]] \
        [--use-checkpoint best|latest] [--num-visualizations N] [--device cpu] \
        [k.e.y=value ...]

scores the checkpoints under <data.base_path>/checkpoints on the test
split and prints the report (losses, cell accuracies, "dcase" and
"dcase2022" metrics) as JSON on standard output, and renders N (default 5)
frames with events as PNGs under <data.base_path>/outputs/test_visualizations; --tta decodes the
ACS test-time-augmented forward ("mel_iv" models), losses staying on the
plain one; --int8 scores the int8 post-training-quantized forward
(seld_tpu_torch.quant, calibrated on the first eval batches; losses too),
--int8-weight-only its weight-only variant.

    python -m seld_tpu_torch.cli calibrate [--synthetic] [--bg-bias-sweep B1,B2] \
        [--accdoa-threshold-sweep T1,T2] [--median-widths W1,W2] [--tta] \
        [--tta-transforms 0,4] [--int8 [--int8-weight-only]] \
        [--use-checkpoint best|latest] [--out FILE] [--device cpu] [k.e.y=value ...]

tunes the run's decode (the background bias of a grid model or the
activity threshold of an ACCDOA model, then the median-filter width) on
the test split, which should then be a validation split, and writes
<data.base_path>/checkpoints/decode_calibration.json unless --out names
another file; `eval` and `predict` take it back with --calibration FILE,
where a flag given explicitly wins over the file, and a file tuned with
--tta (--int8) turns TTA (int8) on.

    python -m seld_tpu_torch.cli score --pred-dir P --gt-dir G [--macro-over all|gt] \
        [k.e.y=value ...]

prints the official DCASE2022 metrics of the prediction CSVs under P
against the ground-truth CSVs of the same names under G.

    python -m seld_tpu_torch.cli verify [--frames T] [--device cpu]

checks every backbone's output shape on a (2, T, C, 64) input, C the
feature set's channel count (4, 7 for mel_iv, 10 for mel_gcc).

    python -m seld_tpu_torch.cli predict [k.e.y=value ...] --wavs A.wav ... \
        [--checkpoint FILE | --artifact FILE] [--out DIR] [--overlap F] [--stream] \
        [--tta] [--tta-transforms 0,4] [--tta-fold K] [--int8 [--int8-calib N]] \
        [--bg-bias B] [--accdoa-threshold T] [--median-filter W] [--calibration FILE] \
        [--device cpu]

writes DIR/predictions/<wav stem>.csv (DIR: --out, else
<data.base_path>/outputs) with the STARSS22-style metadata rows of each
clip. It serves FILE, any checkpoint that `train` wrote, or without
--checkpoint the newest best checkpoint under <data.base_path>/checkpoints,
or an artifact of `export` (--artifact: its bias, threshold and median
width came with it; --median-filter still overrides the width). --stream
feeds each clip in 1 s chunks through a StreamingSession (the same CSV);
--tta averages the 16 ACS scene transforms (or the listed ones) of a
"mel_iv" model; --int8 serves the int8 post-training-quantized forward,
its activation scales calibrated on the first N clips (--int8-calib N,
default 1).

    python -m seld_tpu_torch.cli export [k.e.y=value ...] --out FILE \
        [--checkpoint FILE] [--batch-windows N] [--bg-bias B] [--median-filter W] \
        [--accdoa-threshold T] [--calibration FILE] \
        [--int8-calib-wavs C.wav ... [--int8-weight-only]] [--device cpu]

writes the serving artifact (seld_tpu_torch.export): FILE and FILE.probs,
the two forwards as torch.export programs with the weights inside, and
the sidecar FILE.json. The programs run only on the device type they were
exported for, so --device takes the place of the JAX package's
--platforms. --int8-calib-wavs exports the int8 forwards, calibrated on
those WAVs (int8 weights and scales inside), --int8-weight-only their
weight-only variant.

    python -m seld_tpu_torch.cli serve [k.e.y=value ...] [--checkpoint FILE | \
        --artifact FILE] [--host H] [--port P] [--max-streams N] [--batch-streams] \
        [--batch-wait-ms MS] [--bg-bias B] [--accdoa-threshold T] \
        [--int8-calib-wavs C.wav ...] [--device cpu]

runs the TCP streaming daemon (seld_tpu_torch.serve; port 0 picks a free
one, which the "Serving ... on host:port" log line names); --max-streams
exits after N completed streams, --batch-streams packs the windows of
concurrent streams into shared forwards; --int8-calib-wavs serves the int8
forward calibrated on those WAVs.

    python -m seld_tpu_torch.cli average-ckpts --checkpoint-dir RUN \
        --output-dir OUT [--last N | --steps E1,E2]

averages the run's rolling checkpoints (SWA) into OUT/best.

    python -m seld_tpu_torch.cli info [--device cpu] [k.e.y=value ...]

prints the devices (platform, count, name, compute capability, memory)
and the config as JSON.

    python -m seld_tpu_torch.cli import-torch --torch-checkpoint F.pth \
        [--device cpu] [k.e.y=value ...]

converts a checkpoint of the reference PyTorch pipeline (its trainer's
dict or a bare state_dict) into a best checkpoint under
<data.base_path>/checkpoints, which `predict` and `eval` then serve.

All but `score` and `average-ckpts` run on the CUDA card unless --device
names another. Every command takes --synthetic, as the JAX package's do
(it changes nothing where the command reads no corpus), and config
overrides. Each logs to standard output and to
logs/seld_tpu_torch_<command>_<time>.log; a command that fails logs the
exception and returns 1. `train ... train.qat=true` trains quantization-aware (int8
fake-quant with straight-through gradients). `train ...
train.distill_ckpt=DIR [train.distill_alpha=A train.distill_temperature=T
train.distill_track_matching=permutation|position]` distills from the
teacher whose checkpoint tree is DIR (its best checkpoint; same features,
window and grid, same output kind), training on (1 - A) * hard + A * kd.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

from seld_tpu_torch.utils.logging import setup_logging

logger = logging.getLogger("seld_tpu_torch")


def _normalize_config(cfg):
    """ACCDOA models train and score on ACCDOA targets: three tracks of them
    for multi-ACCDOA."""
    from seld_tpu_torch.models.registry import ACCDOA_MODELS, MULTI_ACCDOA_MODELS

    if cfg.model.model_type in ACCDOA_MODELS and not cfg.targets.accdoa:
        logger.info("model %s: enabling targets.accdoa", cfg.model.model_type)
        cfg = cfg.replace_path("targets.accdoa", True)
    if cfg.model.model_type in MULTI_ACCDOA_MODELS and cfg.targets.accdoa_tracks == 1:
        logger.info("model %s: setting targets.accdoa_tracks=3", cfg.model.model_type)
        cfg = cfg.replace_path("targets.accdoa_tracks", 3)
    return cfg


def _parse_tta_transforms(spec: str | None):
    """The transform subset of --tta-transforms; None means all 16."""
    if not spec:
        return None
    return tuple(int(t) for t in spec.split(",") if t.strip())


def _tta_transforms(args):
    """The validated transform subset a command's --tta / --tta-transforms
    ask for, or None."""
    from seld_tpu_torch.tta import validate_transforms

    if getattr(args, "tta", False) or getattr(args, "tta_transforms", None):
        return validate_transforms(_parse_tta_transforms(getattr(args, "tta_transforms", None)))
    return None


def _apply_calibration(args, run_cfg) -> None:
    """Fill the decode flags that were not given (None) from the file of
    --calibration, after checking it against run_cfg, the config of the
    checkpoint the command serves: an explicit flag, 0 included, wins over
    the file. A file tuned under TTA turns TTA on with its transforms, its
    knobs being that decode's optimum, unless --tta or --tta-transforms was
    given; one tuned under int8 turns --int8 (and --int8-weight-only) on, or
    for `export` demands --int8-calib-wavs (the JAX package's rules, word
    for word)."""
    from seld_tpu_torch.calibrate import check_calibration_matches, load_calibration

    if getattr(args, "artifact", None):
        raise ValueError("--calibration does not compose with --artifact: export with "
                         "--calibration instead — the artifact then carries the tuned decode")
    calib = load_calibration(args.calibration)
    check_calibration_matches(calib, run_cfg)
    applied = []
    for knob, convert in (("bg_bias", float), ("accdoa_threshold", float),
                          ("median_filter", int)):
        if knob in calib and getattr(args, knob) is None:
            setattr(args, knob, convert(calib[knob]))
            applied.append(f"{knob}={getattr(args, knob):g}")
    if calib.get("tta") and not (getattr(args, "tta", False)
                                 or getattr(args, "tta_transforms", None)):
        if not hasattr(args, "tta"):
            raise ValueError("this calibration was tuned under TTA, which this command cannot "
                             "apply — recalibrate without --tta, or use predict/eval "
                             "--calibration")
        args.tta = True
        if calib.get("tta_transforms"):
            args.tta_transforms = ",".join(str(t) for t in calib["tta_transforms"])
        applied.append("tta=on")
    if calib.get("int8"):
        if hasattr(args, "int8") and not args.int8:
            args.int8 = True
            applied.append("int8=on")
        elif hasattr(args, "int8_calib_wavs") and not args.int8_calib_wavs:
            # export: int8 weights need a calibration pass over audio
            raise ValueError("this calibration was tuned under int8 — pass --int8-calib-wavs "
                             "so export can bake the quantized forward")
        if calib.get("int8_weight_only"):
            if not hasattr(args, "int8_weight_only"):
                raise ValueError("this calibration was tuned under int8 weight-only "
                                 "quantization, which this command cannot apply")
            if not args.int8_weight_only:
                args.int8_weight_only = True
                applied.append("int8_weight_only=on")
    logger.info("Applied calibration %s: %s", args.calibration,
                ", ".join(applied) if applied else "(no unset knobs)")


def _serving_checkpoint(args, cfg) -> Path:
    """--checkpoint FILE, or else the newest best checkpoint of the run
    under cfg.data.checkpoint_path."""
    from seld_tpu_torch.train.checkpoint import checkpoint_file

    if args.checkpoint:
        return Path(args.checkpoint)
    found = checkpoint_file(cfg.data.checkpoint_path, "best")
    if found is None:
        raise FileNotFoundError(f"no best checkpoint under {cfg.data.checkpoint_path}/best "
                                "(train first, or pass --checkpoint FILE)")
    return found


def _refuse_with_artifact(args) -> None:
    """The decode knobs an artifact baked at export time (the JAX package's
    refusals, word for word)."""
    if args.bg_bias:
        raise ValueError("--bg-bias does not compose with --artifact: the bias is baked at "
                         "export time (export --bg-bias)")
    if args.accdoa_threshold is not None:
        raise ValueError("--accdoa-threshold does not compose with --artifact: the threshold "
                         "is baked at export time (export --accdoa-threshold)")


def _load_waves(paths) -> list:
    from seld_tpu_torch.data.audio import load_wav

    return [load_wav(path)[0] for path in paths]


def cmd_predict(args) -> int:
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.postprocess import validate_width
    from seld_tpu_torch.train.checkpoint import load_checkpoint

    cfg = parse_overrides(Config(), args.overrides)
    if args.artifact:
        if args.calibration:
            _apply_calibration(args, cfg)  # raises: it does not compose
        if args.int8:
            raise ValueError("--int8 does not compose with --artifact: int8 is baked at export "
                             "time (export --int8-calib-wavs)")
        _refuse_with_artifact(args)
        predictor = SELDPredictor.from_artifact(args.artifact, device=args.device)
        if args.median_filter is not None:  # a host-side post-op: 0 turns it off
            predictor.median_filter = validate_width(args.median_filter)
    else:
        checkpoint = _serving_checkpoint(args, cfg)
        if args.calibration:
            _apply_calibration(args, load_checkpoint(checkpoint)[0])
        predictor = SELDPredictor(
            checkpoint, bg_bias=args.bg_bias or 0.0, median_filter=args.median_filter or 0,
            accdoa_threshold=args.accdoa_threshold, device=args.device,
        )
    if args.int8:
        # activation scales self-calibrated on the first clip(s) served
        predictor.quantize(calib_waves=_load_waves(args.wavs[:max(1, args.int8_calib)]))
    transforms = _tta_transforms(args)
    if transforms is not None:
        predictor.tta(transforms, fold=args.tta_fold)
    out_dir = Path(args.out or cfg.data.output_path) / "predictions"
    for wav in args.wavs:
        csv_out = out_dir / f"{Path(wav).stem}.csv"
        pred = predictor.predict_file(wav, csv_out=csv_out, overlap=args.overlap,
                                      stream=args.stream)
        logger.info("%s: %d frames, %d active cells -> %s",
                    wav, pred.classes.shape[0], len(pred.events()), csv_out)
    return 0


def cmd_export(args) -> int:
    """The serving artifact of a checkpoint, with the decode that flags or a
    calibration file give baked in."""
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.export import export_serving
    from seld_tpu_torch.train.checkpoint import load_checkpoint

    cfg = parse_overrides(Config(), args.overrides)
    checkpoint = _serving_checkpoint(args, cfg)
    if args.calibration:
        _apply_calibration(args, load_checkpoint(checkpoint)[0])
    if args.int8_weight_only and not args.int8_calib_wavs:
        raise ValueError("--int8-weight-only requires --int8-calib-wavs (the calibration pass "
                         "discovers the quantizable layers)")
    out = export_serving(checkpoint, args.out, batch_windows=args.batch_windows,
                         bg_bias=args.bg_bias or 0.0, median_filter=args.median_filter or 0,
                         accdoa_threshold=args.accdoa_threshold, device=args.device,
                         int8_calib_waves=(_load_waves(args.int8_calib_wavs)
                                           if args.int8_calib_wavs else None),
                         int8_weight_only=args.int8_weight_only)
    logger.info("Serving artifact written: %s", out)
    return 0


def cmd_serve(args) -> int:
    """The TCP streaming daemon (seld_tpu_torch.serve has the protocol)."""
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.infer import SELDPredictor
    from seld_tpu_torch.serve import SELDServer

    cfg = parse_overrides(Config(), args.overrides)
    if args.artifact:
        if args.int8_calib_wavs:
            raise ValueError("--int8-calib-wavs does not compose with --artifact: int8 is baked "
                             "at export time (export --int8-calib-wavs)")
        _refuse_with_artifact(args)
        predictor = SELDPredictor.from_artifact(args.artifact, device=args.device)
    else:
        predictor = SELDPredictor(_serving_checkpoint(args, cfg), bg_bias=args.bg_bias,
                                  accdoa_threshold=args.accdoa_threshold, device=args.device)
    if args.int8_calib_wavs:
        predictor.quantize(calib_waves=_load_waves(args.int8_calib_wavs))
    server = SELDServer(predictor, host=args.host, port=args.port,
                        max_streams=args.max_streams, batch_streams=args.batch_streams,
                        batch_wait_s=args.batch_wait_ms / 1000.0)
    logger.info("Serving %s on %s:%d (%s%s) — Ctrl-C to stop",
                predictor.cfg.model.model_type, args.host, server.port,
                "int8" if predictor.quantized else "float",
                ", cross-stream batching" if args.batch_streams else "")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("serve: interrupted, shutting down")
    finally:
        server.server_close()
    return 0


def _build_corpora(cfg, synthetic: bool, device):
    """(train, test) corpora: the seeded synthetic clips, or the files
    under data.base_path through the corpus cache (data.cache_dir; the
    synthetic corpora bypass it)."""
    if synthetic:
        logger.info("Using synthetic data (no STARSS22 corpus required)")
        from seld_tpu_torch.data.synthetic import synthetic_corpus

        return (synthetic_corpus(cfg, n_files=2, seconds=30.0, seed=0, train=True,
                                 device=device),
                synthetic_corpus(cfg, n_files=1, seconds=20.0, seed=1, train=False,
                                 device=device))
    from seld_tpu_torch.data.cache import cached_build_corpus
    from seld_tpu_torch.data.discovery import discover_files

    tr_a, tr_m, te_a, te_m = discover_files(cfg.data)
    logger.info("Discovered %d train / %d test files", len(tr_a), len(te_a))
    parts = (cfg.features, cfg.grid, cfg.window, cfg.targets)
    return (cached_build_corpus(tr_a, tr_m, *parts, train=True,
                                cache_dir=cfg.data.cache_dir, device=device),
            cached_build_corpus(te_a, te_m, *parts, train=False,
                                cache_dir=cfg.data.cache_dir, device=device))


def cmd_train(args) -> int:
    from seld_tpu_torch import resolve_device
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.parallel.multihost import launched_world_size
    from seld_tpu_torch.train.trainer import check_mesh_config, train_model

    device = resolve_device(args.device)
    cfg = _normalize_config(parse_overrides(Config(), args.overrides))
    if args.eval_after and (cfg.mesh.enable == "on" or (
            cfg.mesh.enable == "auto" and launched_world_size() > 1)):
        raise NotImplementedError(
            "train --eval-after under a process mesh is not ported (evaluation under a "
            "mesh is ROADMAP item 10's remainder)")
    check_mesh_config(cfg, cfg.window.window_frames(cfg.features))  # before any corpus
    train_c, test_c = _build_corpora(cfg, args.synthetic, device)
    try:
        _, history = train_model(cfg, train_c, test_c, workdir=cfg.data.checkpoint_path,
                                 resume=args.resume, device=device)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    logger.info("Done: best train %.6f (epoch %d), best test %.6f",
                history["best_train_loss"], history["best_epoch"],
                history["best_test_loss"])
    if args.eval_after:
        return _evaluate(cfg, args, test_c, device)
    return 0


def _csv(spec, convert):
    return [convert(x) for x in str(spec).split(",") if x.strip()] if spec else None


def _int8_flags(args) -> tuple[bool, bool]:
    """(--int8, --int8-weight-only) of eval or calibrate (False for a parser
    without them)."""
    int8 = getattr(args, "int8", False)
    int8_weight_only = getattr(args, "int8_weight_only", False)
    if int8_weight_only and not int8:
        raise ValueError("--int8-weight-only requires --int8")
    return int8, int8_weight_only


def _evaluate(cfg, args, test_corpus, device) -> int:
    """Score cfg's checkpoint tree, render --num-visualizations PNGs and
    print the report, without its list of PNGs, as JSON. `train
    --eval-after` comes here with the train parser's namespace, which has
    none of the decode flags: they keep their defaults."""
    from seld_tpu_torch.eval import evaluate_model

    int8, int8_weight_only = _int8_flags(args)
    results = evaluate_model(
        cfg, test_corpus, cfg.data.checkpoint_path,
        num_visualizations=getattr(args, "num_visualizations", 5),
        bg_bias=getattr(args, "bg_bias", None) or 0.0,
        bg_bias_sweep=_csv(getattr(args, "bg_bias_sweep", None), float),
        accdoa_threshold=getattr(args, "accdoa_threshold", None),
        accdoa_threshold_sweep=_csv(getattr(args, "accdoa_threshold_sweep", None), float),
        median_filter=getattr(args, "median_filter", None) or 0,
        median_filter_sweep=_csv(getattr(args, "median_filter_sweep", None), int),
        use_checkpoint=getattr(args, "use_checkpoint", "best"),
        device=device,
        tta_transforms=_tta_transforms(args),
        int8=int8,
        int8_weight_only=int8_weight_only,
    )
    printable = {k: v for k, v in results.items() if k != "visualizations"}
    print(json.dumps(printable, indent=2, default=str))
    return 0


def cmd_eval(args) -> int:
    from seld_tpu_torch import resolve_device
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.train.checkpoint import load_checkpoint_config

    device = resolve_device(args.device)
    cfg = _normalize_config(parse_overrides(Config(), args.overrides))
    if args.calibration:
        _apply_calibration(args, load_checkpoint_config(cfg.data.checkpoint_path) or cfg)
    _int8_flags(args)  # before the corpus is built
    _, test_c = _build_corpora(cfg, args.synthetic, device)
    return _evaluate(cfg, args, test_c, device)


def cmd_calibrate(args) -> int:
    """Tune the decode on the test split (point the data at a validation
    split: calibrating on the test split spoils its evaluation) and write
    the calibration file."""
    from seld_tpu_torch import resolve_device
    from seld_tpu_torch.calibrate import run_calibration, write_calibration
    from seld_tpu_torch.config import Config, parse_overrides

    device = resolve_device(args.device)
    cfg = _normalize_config(parse_overrides(Config(), args.overrides))
    int8, int8_weight_only = _int8_flags(args)
    _, val_c = _build_corpora(cfg, args.synthetic, device)
    calib = run_calibration(
        cfg, val_c, cfg.data.checkpoint_path, int8=int8,
        int8_weight_only=int8_weight_only, bias_grid=_csv(args.bg_bias_sweep, float),
        threshold_grid=_csv(args.accdoa_threshold_sweep, float),
        median_widths=_csv(args.median_widths, int), use_checkpoint=args.use_checkpoint,
        device=device, tta_transforms=_tta_transforms(args))
    out = Path(args.out) if args.out else (
        Path(cfg.data.checkpoint_path) / "decode_calibration.json")
    write_calibration(calib, out)
    print(json.dumps({k: v for k, v in calib.items()
                      if k not in ("knob_sweep", "median_sweep")}, indent=2))
    return 0


def cmd_score(args) -> int:
    """Official DCASE2022 metrics of prediction CSVs against ground-truth
    CSVs; no model and no device."""
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.eval.score import match_csv_dirs, score_csv_pairs

    cfg = parse_overrides(Config(), args.overrides)
    pairs = match_csv_dirs(args.pred_dir, args.gt_dir)
    logger.info("Scoring %d CSV pair(s)", len(pairs))
    result = score_csv_pairs(pairs, cfg, macro_over=args.macro_over)
    logger.info("DCASE2022 (official): ER %.3f F %.3f LE_CD %.1f deg LR_CD %.3f | "
                "SELD_error %.3f (%d files, Nref %d)", result["ER"], result["F_macro"],
                result["LE_macro"], result["LR_macro"], result["SELD_error"],
                result["n_files"], result["Nref"])
    print(json.dumps(result, indent=2))
    return 0


def cmd_average_ckpts(args) -> int:
    """SWA: average the run's rolling checkpoints into a new best one; no
    device."""
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.tools.average_ckpt import average_checkpoints

    parse_overrides(Config(), args.overrides)  # an unknown field fails as in every command
    summary = average_checkpoints(args.checkpoint_dir, args.output_dir, last=args.last,
                                  steps=_csv(args.steps, int))
    logger.info("SWA checkpoint written: %s (averaged epochs %s, %s params)",
                args.output_dir, summary["steps"], f"{summary['n_params']:,}")
    return 0


def cmd_info(args) -> int:
    """The devices and the config as JSON."""
    from seld_tpu_torch import resolve_device
    from seld_tpu_torch.config import Config, config_to_dict, parse_overrides
    from seld_tpu_torch.utils.platform import describe_devices

    device = resolve_device(args.device)
    cfg = parse_overrides(Config(), args.overrides)
    info = describe_devices(device, logger)
    print(json.dumps({"devices": info, "config": config_to_dict(cfg)}, indent=2))
    return 0


def _load_reference_checkpoint(path):
    """A .pth of the reference pipeline: weights_only first; its trainer's
    files pickle their Config, which a permissive stand-in module lets the
    unpickler rebuild (the JAX package's `_load`)."""
    import types

    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        shim = types.ModuleType("config")

        class _AnyConfig:
            def __setstate__(self, state):
                self.__dict__.update(state if isinstance(state, dict) else {})

        shim.Config = _AnyConfig
        sys.modules.setdefault("config", shim)
        return torch.load(path, map_location="cpu", weights_only=False)


def cmd_import_torch(args) -> int:
    """A reference PyTorch checkpoint -> a best checkpoint of the port under
    <data.base_path>/checkpoints (fresh Adam state, the file's epoch and
    test loss), after a forward at (1, 8, C, n_mels)."""
    import numpy as np
    import torch

    from seld_tpu_torch import resolve_device
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.models import build_model
    from seld_tpu_torch.tools.torch_import import import_state_dict
    from seld_tpu_torch.train.checkpoint import CheckpointManager
    from seld_tpu_torch.train.optimizer import make_optimizer
    from seld_tpu_torch.train.state import create_train_state

    device = resolve_device(args.device)
    cfg = parse_overrides(Config(), args.overrides)
    ckpt = _load_reference_checkpoint(args.torch_checkpoint)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
          for k, v in sd.items() if hasattr(v, "shape") or hasattr(v, "numpy")}
    n_ch = feature_channels(cfg.features.feature_set, cfg.model.n_channels)
    model = build_model(cfg.model, cfg.grid, device=device, in_channels=n_ch)
    model.load_state_dict(import_state_dict(sd, cfg.model, cfg.grid.num_classes))
    model.eval()
    with torch.inference_mode():  # the forward at the production shape
        out = model(torch.zeros((1, 8, n_ch, cfg.model.n_mels), device=device))
    want = (1, 8, cfg.grid.num_classes, cfg.grid.n_cells)
    if tuple(out.shape) != want:
        raise ValueError(f"imported {cfg.model.model_type}: output {tuple(out.shape)}, "
                         f"expected {want}")
    state = create_train_state(model, make_optimizer(
        model.parameters(), cfg.train.learning_rate, cfg.train.weight_decay))
    is_dict = isinstance(ckpt, dict)
    epoch = int(ckpt.get("epoch", 0)) if is_dict else 0
    test_loss = float(ckpt.get("test_loss", float("inf"))) if is_dict else float("inf")
    path = CheckpointManager(cfg.data.checkpoint_path, cfg).save_best(
        max(epoch, 1), state, float("nan"), test_loss)
    logger.info("Imported %s (%s) -> %s", args.torch_checkpoint, cfg.model.model_type, path)
    return 0


# backbones of seld_tpu's `verify`, in its order
VERIFY_BACKBONES = ("resnet_conformer", "cnn", "crnn", "conformer", "accdoa_conformer",
                    "multi_accdoa_conformer")


def cmd_verify(args) -> int:
    """Shape contract of every backbone: a (2, T, C, F) input gives finite
    class-major (2, T, M, G) logits, (2, T, M - 1, 3) ACCDOA vectors or
    (2, T, 3, M - 1, 3) multi-ACCDOA vectors."""
    import torch

    from seld_tpu_torch import resolve_device
    from seld_tpu_torch.config import Config, ModelConfig, parse_overrides
    from seld_tpu_torch.features.spatial import feature_channels
    from seld_tpu_torch.models import build_model

    device = resolve_device(args.device)
    cfg = parse_overrides(Config(), args.overrides)
    b, t = 2, args.frames
    c = feature_channels(cfg.features.feature_set, cfg.model.n_channels)
    x = torch.zeros((b, t, c, cfg.model.n_mels), device=device)
    events = cfg.grid.num_classes - 1
    failures = 0
    for model_type in VERIFY_BACKBONES:
        if model_type == "multi_accdoa_conformer":
            expect = (b, t, 3, events, 3)
        elif model_type == "accdoa_conformer":
            expect = (b, t, events, 3)
        else:
            expect = (b, t, cfg.grid.num_classes, cfg.grid.n_cells)
        mcfg = ModelConfig(model_type=model_type, compute_dtype="float32")
        model = build_model(mcfg, cfg.grid, device=device, seed=0, in_channels=c)
        with torch.inference_mode():
            out = model(x)
        ok = tuple(out.shape) == expect and bool(torch.isfinite(out).all())
        failures += not ok
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{model_type:>22}: {tuple(x.shape)} -> {tuple(out.shape)} "
              f"{'OK' if ok else 'FAIL'} | {n_params:,} params")
    return 1 if failures else 0


def _add_tta_flags(p, what: str) -> None:
    p.add_argument("--tta", action="store_true",
                   help=f"ACS test-time augmentation: {what} averaged over the 16 label-exact "
                   "FOA scene transforms (16x the forwards; features.feature_set=mel_iv)")
    p.add_argument("--tta-transforms", default=None, metavar="T1,T2,...",
                   help="comma-separated transform subset for TTA (e.g. 0,1,2,3: the four "
                   "azimuth rotations); implies --tta")


def _add_int8_flags(p, what: str) -> None:
    p.add_argument("--int8", action="store_true",
                   help=f"{what} the int8 post-training-quantized forward (self-calibrated "
                   "on the first eval batches)")
    p.add_argument("--int8-weight-only", action="store_true",
                   help="with --int8: quantize weights only (compute-dtype products: the "
                   "export --int8-weight-only numerics)")


def _add_viz_flag(p) -> None:
    p.add_argument("--num-visualizations", type=int, default=5, metavar="N",
                   help="PNGs of N frames with events into outputs/test_visualizations, "
                   "from one more forward of their windows (default 5; 0: none)")


def _add_checkpoint_flags(p) -> None:
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file (default: the newest best checkpoint under "
                   "<data.base_path>/checkpoints)")
    p.add_argument("--artifact", default=None,
                   help="serve an `export` artifact instead of a checkpoint")


def _add_synthetic_flag(p) -> None:
    p.add_argument("--synthetic", action="store_true",
                   help="accepted as the JAX package's commands accept it; this command "
                   "reads no corpus")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m seld_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    device_help = "torch device (default: cuda; 'cpu' runs the plain versions on the CPU)"
    p = sub.add_parser("train", help="train per config; key=value overrides")
    p.add_argument("overrides", nargs="*",
                   help="dotted config overrides, k.e.y=value (train.qat=true: quantization-"
                        "aware; train.distill_ckpt=DIR: distill from the teacher run DIR)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on seeded synthetic clips instead of STARSS22")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest rolling checkpoint")
    p.add_argument("--eval-after", action="store_true",
                   help="score the run as `eval` does once training returns")
    _add_viz_flag(p)
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser(
        "eval", help="score the run's checkpoints on the test split; prints the report "
        "as JSON and renders prediction PNGs into outputs/test_visualizations")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    p.add_argument("--synthetic", action="store_true",
                   help="score on the seeded synthetic test clip instead of STARSS22")
    p.add_argument("--bg-bias", type=float, default=None, metavar="B",
                   help="reduce the background logit by B before decoding (default 0)")
    p.add_argument("--bg-bias-sweep", default=None, metavar="B1,B2,...",
                   help="also report DCASE2022 metrics at each of these biases, and the best")
    p.add_argument("--accdoa-threshold", type=float, default=None, metavar="T",
                   help="vector-norm activity threshold of ACCDOA decodes (default 0.5)")
    p.add_argument("--accdoa-threshold-sweep", default=None, metavar="T1,T2,...",
                   help="also report DCASE2022 metrics at each of these thresholds, and the "
                   "best")
    p.add_argument("--median-filter", type=int, default=None, metavar="W",
                   help="odd W-frame majority smoothing of the class grids (default 0: off)")
    p.add_argument("--median-filter-sweep", default=None, metavar="W1,W2,...",
                   help="also report DCASE2022 metrics at each of these widths, and the best")
    p.add_argument("--calibration", default=None, metavar="FILE",
                   help="take --bg-bias / --accdoa-threshold / --median-filter (and TTA or "
                   "int8, for a file tuned under it) from a `calibrate` file; a flag given "
                   "explicitly wins")
    p.add_argument("--use-checkpoint", default="best", choices=("best", "latest"),
                   help="score the best checkpoint, or the newest rolling one")
    _add_tta_flags(p, "the decodes (every metric and sweep; losses stay plain)")
    _add_int8_flags(p, "score")
    _add_viz_flag(p)
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_eval)
    p = sub.add_parser(
        "calibrate", help="tune the decode (bias or threshold, then median width) on the "
        "test split, which should be a validation split; writes decode_calibration.json")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    p.add_argument("--synthetic", action="store_true",
                   help="calibrate on the seeded synthetic test clip instead of STARSS22")
    p.add_argument("--bg-bias-sweep", default=None, metavar="B1,B2,...",
                   help="candidate background biases of a grid model "
                   "(default -1,-0.5,0,0.5,1,1.5,2,3)")
    p.add_argument("--accdoa-threshold-sweep", default=None, metavar="T1,T2,...",
                   help="candidate activity thresholds of an ACCDOA model "
                   "(default 0.2,0.3,0.4,0.5,0.6,0.7)")
    p.add_argument("--median-widths", default=None, metavar="W1,W2,...",
                   help="candidate median-filter widths (default 1,3,5,7; 1 is off)")
    p.add_argument("--use-checkpoint", default="best", choices=("best", "latest"),
                   help="calibrate the best checkpoint, or the newest rolling one")
    p.add_argument("--out", default=None,
                   help="output file (default <checkpoint_path>/decode_calibration.json)")
    _add_tta_flags(p, "the decode both passes tune")
    _add_int8_flags(p, "tune the decode of")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_calibrate)
    p = sub.add_parser("score", help="official DCASE2022 metrics of prediction CSVs "
                       "against ground-truth CSVs")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    _add_synthetic_flag(p)
    p.add_argument("--pred-dir", required=True, help="directory of predicted CSVs")
    p.add_argument("--gt-dir", required=True,
                   help="directory of ground-truth CSVs (matched by file name)")
    p.add_argument("--macro-over", choices=("all", "gt"), default="all",
                   help="macro-average over all classes (official) or only those in the "
                   "ground truth")
    p.set_defaults(fn=cmd_score)
    p = sub.add_parser("verify", help="output-shape contract of every backbone")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    _add_synthetic_flag(p)
    p.add_argument("--frames", type=int, default=250, help="input frames T (default 250)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_verify)
    p = sub.add_parser("predict", help="WAV file(s) -> STARSS22-style CSV per clip")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    _add_synthetic_flag(p)
    _add_checkpoint_flags(p)
    p.add_argument("--wavs", nargs="+", required=True)
    p.add_argument("--out", default=None,
                   help="output directory (default <data.base_path>/outputs); CSVs go to "
                   "OUT/predictions")
    p.add_argument("--overlap", type=float, default=0.0,
                   help="window overlap in [0, 1): average class probabilities "
                   "over overlapping windows before decoding")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory streaming inference in 1 s chunks (the same CSV)")
    _add_tta_flags(p, "predictions")
    p.add_argument("--int8", action="store_true",
                   help="int8 post-training-quantized inference; activation scales "
                   "self-calibrate on the input clips (not with --artifact)")
    p.add_argument("--int8-calib", type=int, default=1, metavar="N",
                   help="number of input clips used for int8 calibration")
    p.add_argument("--tta-fold", type=int, default=1, metavar="K",
                   help="TTA views in each forward's batch (must divide the transform count; "
                   "folds agree to ~1e-6, streaming stays bit-equal at one fold)")
    p.add_argument("--bg-bias", type=float, default=None, metavar="B",
                   help="reduce the background logit by B before decoding (grid models)")
    p.add_argument("--accdoa-threshold", type=float, default=None, metavar="T",
                   help="vector-norm activity threshold of ACCDOA decodes (default 0.5)")
    p.add_argument("--median-filter", type=int, default=None, metavar="W",
                   help="odd W-frame majority smoothing of the class grid")
    p.add_argument("--calibration", default=None, metavar="FILE",
                   help="take --bg-bias / --accdoa-threshold / --median-filter (and TTA or "
                   "int8, for a file tuned under it) from a `calibrate` file; a flag given "
                   "explicitly wins; not with --artifact (export --calibration)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_predict)
    p = sub.add_parser("export", help="the serving artifact: torch.export programs of the "
                       "forwards, weights inside, and a JSON sidecar")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    _add_synthetic_flag(p)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file (default: the run's newest best checkpoint)")
    p.add_argument("--out", required=True,
                   help="artifact path; OUT.probs and OUT.json are written beside it")
    p.add_argument("--batch-windows", type=int, default=8,
                   help="windows a forward (the programs' fixed batch)")
    p.add_argument("--bg-bias", type=float, default=None, metavar="B",
                   help="bake a background decode bias into the programs (grid models)")
    p.add_argument("--median-filter", type=int, default=None, metavar="W",
                   help="record a median-filter width in the sidecar (a host-side post-op "
                   "that from_artifact applies)")
    p.add_argument("--accdoa-threshold", type=float, default=None, metavar="T",
                   help="bake an ACCDOA activity threshold into the programs")
    p.add_argument("--calibration", default=None, metavar="FILE",
                   help="bake a `calibrate` file's decode (bias or threshold into the "
                   "programs, median width into the sidecar); a file tuned under TTA is "
                   "refused (an artifact serves the plain forward), one tuned under int8 "
                   "needs --int8-calib-wavs")
    p.add_argument("--int8-calib-wavs", nargs="+", default=None,
                   help="export the int8 PTQ forward instead, calibrated on these WAVs (int8 "
                   "weights and scales bake into the programs)")
    p.add_argument("--int8-weight-only", action="store_true",
                   help="with --int8-calib-wavs: quantize weights only (int8 storage, "
                   "compute-dtype products: a smaller artifact at near-float accuracy)")
    p.add_argument("--device", default=None,
                   help="the device type the programs run on (default: cuda); the JAX "
                   "package's --platforms")
    p.set_defaults(fn=cmd_export)
    p = sub.add_parser("serve", help="the TCP streaming daemon (bit-equal to offline "
                       "prediction; bounded memory per stream)")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    _add_synthetic_flag(p)
    _add_checkpoint_flags(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8771, help="0 picks a free port")
    p.add_argument("--max-streams", type=int, default=0,
                   help="exit after N completed streams (0: run until interrupted)")
    p.add_argument("--batch-streams", action="store_true",
                   help="pack the windows of concurrent streams into shared forwards "
                   "(every stream stays bit-equal to offline)")
    p.add_argument("--batch-wait-ms", type=float, default=0.0,
                   help="with --batch-streams: hold a partial batch open this long for more "
                   "streams to join (0: never delay a free worker)")
    p.add_argument("--bg-bias", type=float, default=0.0, metavar="B",
                   help="background decode bias (grid models); not with --artifact")
    p.add_argument("--accdoa-threshold", type=float, default=None, metavar="T",
                   help="ACCDOA activity threshold (default 0.5); not with --artifact")
    p.add_argument("--int8-calib-wavs", nargs="+", default=None,
                   help="serve the int8 PTQ forward, calibrated on these WAVs; not with "
                   "--artifact")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_serve)
    p = sub.add_parser("average-ckpts", help="SWA: average a run's rolling checkpoints into "
                       "a new best checkpoint")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    _add_synthetic_flag(p)
    p.add_argument("--checkpoint-dir", required=True,
                   help="the run's checkpoint tree (<data.base_path>/checkpoints)")
    p.add_argument("--output-dir", required=True,
                   help="the new tree; the average is written to OUTPUT_DIR/best")
    p.add_argument("--last", type=int, default=None, metavar="N",
                   help="average the newest N rolling checkpoints (default: all)")
    p.add_argument("--steps", default=None, metavar="E1,E2,...",
                   help="average these epochs' rolling checkpoints (wins over --last)")
    p.set_defaults(fn=cmd_average_ckpts)
    p = sub.add_parser("import-torch", help="a checkpoint of the reference PyTorch pipeline "
                       "-> the run's best checkpoint")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    _add_synthetic_flag(p)
    p.add_argument("--torch-checkpoint", required=True,
                   help=".pth from the reference pipeline (its trainer's dict or a bare "
                   "state_dict)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_import_torch)
    p = sub.add_parser("info", help="the devices and the config as JSON")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    _add_synthetic_flag(p)
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_info)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    log, log_file = setup_logging(experiment_name=f"seld_tpu_torch_{args.command}")
    log.info("Log file: %s", log_file)
    try:
        return args.fn(args)
    except Exception:
        log.exception("%s failed", args.command)
        return 1


if __name__ == "__main__":
    sys.exit(main())
