"""Score prediction CSVs against ground-truth CSVs with the official
DCASE2022 metrics (counterpart: seld_tpu/eval/score.py).

Rows of STARSS22-format CSVs (frame, class, source, azimuth, elevation;
100 ms metadata frames) rasterise to 20 ms uint16 class-bitmask grids
(seld_tpu_torch.targets.rasterize; multi-hot cells kept) and score through
`dcase2022_metrics(bitmask=True)`. Each file's grids are padded to whole
1 s segments before they are joined, so a segment never spans two files.
No model and no device are involved.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from seld_tpu_torch.config import Config
from seld_tpu_torch.eval.metrics import dcase2022_metrics
from seld_tpu_torch.targets.rasterize import encode_events_to_bitmask, load_metadata_csv


def score_csv_pairs(pairs, cfg: Config, frames_per_segment: int = 50,
                    macro_over: str = "all") -> dict:
    """Official DCASE2022 metrics over (pred_csv, gt_csv) pairs, counts
    pooled across the files; the result gains "n_files"."""
    pred_grids, true_grids = [], []
    for pred_csv, gt_csv in pairs:
        rows = {p: load_metadata_csv(p) for p in (pred_csv, gt_csv)}
        t_max = max(((int(r[0].max()) + 1) * cfg.targets.fanout
                     for r in rows.values() if r[0].size), default=0)
        t_lab = max(-(-max(t_max, 1) // frames_per_segment) * frames_per_segment,
                    frames_per_segment)
        for p, grids in ((pred_csv, pred_grids), (gt_csv, true_grids)):
            frames, classes, _src, az, el = rows[p]
            grids.append(encode_events_to_bitmask(frames, classes, az, el, t_lab,
                                                  n_el=cfg.grid.n_el, n_az=cfg.grid.n_az,
                                                  fanout=cfg.targets.fanout))
    result = dcase2022_metrics(
        np.concatenate(pred_grids, axis=0)[None], np.concatenate(true_grids, axis=0)[None],
        n_el=cfg.grid.n_el, n_az=cfg.grid.n_az, num_classes=cfg.grid.num_classes,
        frames_per_segment=frames_per_segment, macro_over=macro_over, bitmask=True,
    )
    result["n_files"] = len(pred_grids)
    return result


def match_csv_dirs(pred_dir, gt_dir) -> list:
    """(pred_csv, gt_csv) pairs matched by file name. A ground-truth file
    without a prediction, or a prediction without ground truth, raises
    FileNotFoundError: either would bend the score silently."""
    pred_dir, gt_dir = Path(pred_dir), Path(gt_dir)
    gt = {p.name: p for p in sorted(gt_dir.glob("*.csv"))}
    pred = {p.name: p for p in sorted(pred_dir.glob("*.csv"))}
    if not gt:
        raise FileNotFoundError(f"no ground-truth CSVs under {gt_dir}")
    missing = sorted(set(gt) - set(pred))
    if missing:
        raise FileNotFoundError(
            f"predictions missing for {len(missing)} ground-truth file(s): "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    extra = sorted(set(pred) - set(gt))
    if extra:
        raise FileNotFoundError(
            f"{len(extra)} prediction file(s) have no ground truth: "
            f"{extra[:5]}{'...' if len(extra) > 5 else ''}")
    return [(pred[name], gt[name]) for name in sorted(gt)]
