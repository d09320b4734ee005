"""Command line (counterpart: seld_tpu/cli.py `predict`).

    python -m seld_tpu_torch.cli predict --checkpoint FILE --wavs A.wav ... \
        [--out DIR] [--overlap F] [--bg-bias B] [--median-filter W] [--device cpu]

writes DIR/predictions/<wav stem>.csv with the STARSS22-style metadata
rows of each clip. It runs on the CUDA card unless --device names another.
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m seld_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
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
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                   "versions on the CPU)")
    p.set_defaults(fn=cmd_predict)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
