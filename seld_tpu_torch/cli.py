"""Command line (counterpart: seld_tpu/cli.py `train`, `eval`, `verify`
and `predict`).

    python -m seld_tpu_torch.cli train [--synthetic] [--resume] [--eval-after] \
        [--device cpu] [k.e.y=value ...]

trains per config (every config field is a dotted key=value override, e.g.
data.base_path=RUN train.num_epochs=2) and writes best/ and rolling/
checkpoints, metrics.jsonl and training_history.json under
<data.base_path>/checkpoints; --eval-after then scores the result as `eval`
does. Over several processes, one GPU each:

    torchrun --standalone --nproc-per-node N -m seld_tpu_torch.cli train \
        mesh.enable=on mesh.model_axis=M mesh.shard_time=true [k.e.y=value ...]

runs a (N / M) x M mesh, the window's time axis split over the M ranks of
each model group (sequence parallelism, ring attention K5); without
shard_time (M = 1) it is data parallel. Each process uses cuda:LOCAL_RANK
and NCCL (one GPU per rank); --device cpu uses gloo. Rank 0 writes the
files.

    python -m seld_tpu_torch.cli eval [--synthetic] [--bg-bias B] \
        [--bg-bias-sweep B1,B2] [--median-filter W] [--median-filter-sweep W1,W2] \
        [--use-checkpoint best|latest] [--device cpu] [k.e.y=value ...]

scores the checkpoints under <data.base_path>/checkpoints on the test
split and prints the report (losses, cell accuracies, "dcase" and
"dcase2022" metrics) as JSON on standard output.

    python -m seld_tpu_torch.cli verify [--frames T] [--device cpu]

checks every backbone's output shape on a (2, T, C, 64) input, C the
feature set's channel count (4, 7 for mel_iv, 10 for mel_gcc).

    python -m seld_tpu_torch.cli predict --checkpoint FILE --wavs A.wav ... \
        [--out DIR] [--overlap F] [--bg-bias B] [--median-filter W] [--device cpu]

writes DIR/predictions/<wav stem>.csv with the STARSS22-style metadata
rows of each clip; FILE may be a checkpoint that `train` wrote. All run on
the CUDA card unless --device names another.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path

logger = logging.getLogger("seld_tpu_torch")


def cmd_predict(args) -> int:
    from seld_tpu_torch.infer import SELDPredictor

    predictor = SELDPredictor(
        args.checkpoint, bg_bias=args.bg_bias, median_filter=args.median_filter,
        device=args.device,
    )
    out_dir = Path(args.out) / "predictions"
    for wav in args.wavs:
        csv_out = out_dir / f"{Path(wav).stem}.csv"
        pred = predictor.predict_file(wav, csv_out=csv_out, overlap=args.overlap)
        logger.info("%s: %d frames, %d active cells -> %s",
                    wav, pred.classes.shape[0], len(pred.events()), csv_out)
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
    from seld_tpu_torch.train.trainer import train_model

    device = resolve_device(args.device)
    cfg = parse_overrides(Config(), args.overrides)
    if args.eval_after and (cfg.mesh.enable == "on" or (
            cfg.mesh.enable == "auto" and launched_world_size() > 1)):
        raise NotImplementedError(
            "train --eval-after under a process mesh is not ported (evaluation under a "
            "mesh is ROADMAP item 10's remainder)")
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


def _evaluate(cfg, args, test_corpus, device) -> int:
    """Score cfg's checkpoint tree and print the report as JSON. `train
    --eval-after` comes here with the train parser's namespace, which has
    none of the decode flags: they keep their defaults."""
    from seld_tpu_torch.eval import evaluate_model

    results = evaluate_model(
        cfg, test_corpus, cfg.data.checkpoint_path,
        save_visualizations=False,
        bg_bias=getattr(args, "bg_bias", None) or 0.0,
        bg_bias_sweep=_csv(getattr(args, "bg_bias_sweep", None), float),
        median_filter=getattr(args, "median_filter", None) or 0,
        median_filter_sweep=_csv(getattr(args, "median_filter_sweep", None), int),
        use_checkpoint=getattr(args, "use_checkpoint", "best"),
        device=device,
    )
    printable = {k: v for k, v in results.items() if k != "visualizations"}
    print(json.dumps(printable, indent=2, default=str))
    return 0


def cmd_eval(args) -> int:
    from seld_tpu_torch import resolve_device
    from seld_tpu_torch.config import Config, parse_overrides

    device = resolve_device(args.device)
    cfg = parse_overrides(Config(), args.overrides)
    _, test_c = _build_corpora(cfg, args.synthetic, device)
    return _evaluate(cfg, args, test_c, device)


# backbones of seld_tpu's `verify`, in its order; the port has the first
VERIFY_BACKBONES = ("resnet_conformer", "cnn", "crnn", "conformer", "accdoa_conformer",
                    "multi_accdoa_conformer")


def cmd_verify(args) -> int:
    """Shape contract of every backbone: a (2, T, C, F) input gives finite
    class-major (2, T, M, G) logits. Backbones the port does not have yet
    are listed as such and fail nothing."""
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
    expect = (b, t, cfg.grid.num_classes, cfg.grid.n_cells)
    failures = 0
    for model_type in VERIFY_BACKBONES:
        mcfg = ModelConfig(model_type=model_type, compute_dtype="float32")
        try:
            model = build_model(mcfg, cfg.grid, device=device, seed=0, in_channels=c)
        except NotImplementedError as e:
            print(f"{model_type:>22}: NOT PORTED ({e})")
            continue
        with torch.inference_mode():
            out = model(x)
        ok = tuple(out.shape) == expect and bool(torch.isfinite(out).all())
        failures += not ok
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{model_type:>22}: {tuple(x.shape)} -> {tuple(out.shape)} "
              f"{'OK' if ok else 'FAIL'} | {n_params:,} params")
    return 1 if failures else 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m seld_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    device_help = "torch device (default: cuda; 'cpu' runs the plain versions on the CPU)"
    p = sub.add_parser("train", help="train per config; key=value overrides")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    p.add_argument("--synthetic", action="store_true",
                   help="train on seeded synthetic clips instead of STARSS22")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest rolling checkpoint")
    p.add_argument("--eval-after", action="store_true",
                   help="score the run as `eval` does once training returns")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser(
        "eval", help="score the run's checkpoints on the test split; prints the report "
        "as JSON (no PNG visualisations: the renderer is not ported)")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    p.add_argument("--synthetic", action="store_true",
                   help="score on the seeded synthetic test clip instead of STARSS22")
    p.add_argument("--bg-bias", type=float, default=None, metavar="B",
                   help="reduce the background logit by B before decoding (default 0)")
    p.add_argument("--bg-bias-sweep", default=None, metavar="B1,B2,...",
                   help="also report DCASE2022 metrics at each of these biases, and the best")
    p.add_argument("--median-filter", type=int, default=None, metavar="W",
                   help="odd W-frame majority smoothing of the class grids (default 0: off)")
    p.add_argument("--median-filter-sweep", default=None, metavar="W1,W2,...",
                   help="also report DCASE2022 metrics at each of these widths, and the best")
    p.add_argument("--use-checkpoint", default="best", choices=("best", "latest"),
                   help="score the best checkpoint, or the newest rolling one")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_eval)
    p = sub.add_parser("verify", help="output-shape contract of every backbone")
    p.add_argument("overrides", nargs="*", help="dotted config overrides, k.e.y=value")
    p.add_argument("--frames", type=int, default=250, help="input frames T (default 250)")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_verify)
    p = sub.add_parser("predict", help="WAV file(s) -> STARSS22-style CSV per clip")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint file written by seld_tpu_torch.train.checkpoint")
    p.add_argument("--wavs", nargs="+", required=True)
    p.add_argument("--out", default="outputs",
                   help="output directory; CSVs go to OUT/predictions")
    p.add_argument("--overlap", type=float, default=0.0,
                   help="window overlap in [0, 1): average class probabilities "
                   "over overlapping windows before decoding")
    p.add_argument("--bg-bias", type=float, default=0.0, metavar="B",
                   help="reduce the background logit by B before decoding")
    p.add_argument("--median-filter", type=int, default=0, metavar="W",
                   help="odd W-frame majority smoothing of the class grid")
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_predict)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
