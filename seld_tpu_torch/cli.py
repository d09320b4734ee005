"""Command line (counterpart: seld_tpu/cli.py `train` and `predict`).

    python -m seld_tpu_torch.cli train [--synthetic] [--resume] [--device cpu] \
        [k.e.y=value ...]

trains per config (every config field is a dotted key=value override, e.g.
data.base_path=RUN train.num_epochs=2) and writes best/ and rolling/
checkpoints, metrics.jsonl and training_history.json under
<data.base_path>/checkpoints.

    python -m seld_tpu_torch.cli predict --checkpoint FILE --wavs A.wav ... \
        [--out DIR] [--overlap F] [--bg-bias B] [--median-filter W] [--device cpu]

writes DIR/predictions/<wav stem>.csv with the STARSS22-style metadata
rows of each clip; FILE may be a checkpoint that `train` wrote. Both run on
the CUDA card unless --device names another.
"""

from __future__ import annotations

import argparse
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
    if synthetic:
        logger.info("Using synthetic data (no STARSS22 corpus required)")
        from seld_tpu_torch.data.synthetic import synthetic_corpus

        return (synthetic_corpus(cfg, n_files=2, seconds=30.0, seed=0, train=True,
                                 device=device),
                synthetic_corpus(cfg, n_files=1, seconds=20.0, seed=1, train=False,
                                 device=device))
    if cfg.data.cache_dir:
        raise NotImplementedError(
            "data.cache_dir: the on-disk corpus cache (seld_tpu/data/cache.py) is "
            "not ported yet (ROADMAP: spatial features and augmentation)"
        )
    from seld_tpu_torch.data.corpus import build_corpus
    from seld_tpu_torch.data.discovery import discover_files

    tr_a, tr_m, te_a, te_m = discover_files(cfg.data)
    logger.info("Discovered %d train / %d test files", len(tr_a), len(te_a))
    parts = (cfg.features, cfg.grid, cfg.window, cfg.targets)
    return (build_corpus(tr_a, tr_m, *parts, train=True, device=device),
            build_corpus(te_a, te_m, *parts, train=False, device=device))


def cmd_train(args) -> int:
    from seld_tpu_torch import resolve_device
    from seld_tpu_torch.config import Config, parse_overrides
    from seld_tpu_torch.train.trainer import train_model

    device = resolve_device(args.device)
    cfg = parse_overrides(Config(), args.overrides)
    train_c, test_c = _build_corpora(cfg, args.synthetic, device)
    _, history = train_model(cfg, train_c, test_c, workdir=cfg.data.checkpoint_path,
                             resume=args.resume, device=device)
    logger.info("Done: best train %.6f (epoch %d), best test %.6f",
                history["best_train_loss"], history["best_epoch"],
                history["best_test_loss"])
    return 0


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
    p.add_argument("--device", default=None, help=device_help)
    p.set_defaults(fn=cmd_train)
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
