"""Regenerate a run's loss-curve PNG and a per-epoch table from its
checkpoints/metrics.jsonl (counterpart: seld_tpu/tools/replot.py).

The trainer appends one record per epoch to metrics.jsonl, with the JAX
package's keys (epoch, seconds, lr, train, test). This tool turns the file
back into the loss-curve PNG and a plain-text summary at any later time:
after the run's outputs/ directory was cleaned, or from another shell
while the run goes on. It runs on the host and needs no device.

Usage:
  python -m seld_tpu_torch.tools.replot checkpoints/metrics.jsonl [--out curves.png]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def load_metrics(path) -> list[dict]:
    records = [
        json.loads(line)
        for line in Path(path).read_text().splitlines() if line.strip()
    ]
    if not records:
        raise ValueError(f"{path}: no epoch records")
    return records


def summarize(records: list[dict]) -> str:
    """Plain-text per-epoch table + best-epoch footer."""
    keys = [k for k in records[0]["train"] if k != "loss"]
    head = f"{'epoch':>5} {'sec':>7} {'lr':>9} {'train':>10} {'test':>10}"
    head += "".join(f" {k[:10]:>10}" for k in keys)
    rows = [head]
    for r in records:
        line = (f"{r['epoch']:5d} {r.get('seconds', 0):7.1f} "
                f"{r['lr']:9.6f} {r['train']['loss']:10.6f} "
                f"{r['test']['loss']:10.6f}")
        line += "".join(f" {r['train'].get(k, float('nan')):10.6f}" for k in keys)
        rows.append(line)
    best = min(records, key=lambda r: r["test"]["loss"])
    rows.append(
        f"best test {best['test']['loss']:.6f} @ epoch {best['epoch']} "
        f"({len(records)} epochs recorded)"
    )
    return "\n".join(rows)


def replot(metrics_path, out_path=None) -> Path:
    """Write the loss-curve PNG (beside metrics.jsonl as
    loss_curves_replot.png unless out_path is given); returns its path."""
    from seld_tpu_torch.viz import plot_loss_curves

    records = load_metrics(metrics_path)
    out = Path(
        out_path if out_path is not None
        else Path(metrics_path).parent / "loss_curves_replot.png"
    )
    plot_loss_curves(
        [r["train"]["loss"] for r in records],
        [r["test"]["loss"] for r in records],
        save_path=out,
    )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("metrics_jsonl")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    records = load_metrics(args.metrics_jsonl)
    print(summarize(records))
    out = replot(args.metrics_jsonl, args.out)
    print(f"loss curves -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
