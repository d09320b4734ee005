"""Stochastic weight averaging (SWA) over a run's rolling checkpoints
(counterpart: seld_tpu/tools/average_ckpt.py).

Averages the weights of the selected rolling checkpoints
(<run>/rolling/epoch_NNNN.pt; Izmailov et al. 2018: tail-averaged
iterates land in flatter minima) and writes the result as the best
checkpoint of a new tree, <out>/best/epoch_NNNN.pt, which `predict`,
`eval` and `calibrate` serve as they serve any best checkpoint.

Every floating entry of the state_dict, parameters and BatchNorm
statistics alike, is averaged leaf-wise in float64 and cast back to its
dtype (BatchNorm's running statistics are long-horizon means already, so
their average stands in for SWA's recomputation of them, which would need
the training corpus). Integer counters, the optimizer state, the step and
the epoch come from the newest source, so a resume from the output stays
well defined; its meta names the sources in "swa_sources".

    python -m seld_tpu_torch.cli average-ckpts --checkpoint-dir RUN \
        --output-dir OUT [--last N | --steps 12,14,16]
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from seld_tpu_torch.features.spatial import feature_channels
from seld_tpu_torch.models import build_model
from seld_tpu_torch.train.checkpoint import epoch_files, load_checkpoint_config, save_checkpoint

logger = logging.getLogger(__name__)


def mean_state_dicts(states: list[dict]) -> dict:
    """Leaf-wise float64 mean of same-keyed state_dicts, each floating
    entry cast back to its dtype; other entries from the last one."""
    out = {}
    for key, last in states[-1].items():
        if torch.is_floating_point(last):
            acc = torch.stack([s[key].to(torch.float64) for s in states]).mean(dim=0)
            out[key] = acc.to(last.dtype)
        else:
            out[key] = last
    return out


def average_checkpoints(checkpoint_dir, output_dir, last: int | None = None,
                        steps=None) -> dict:
    """Average rolling checkpoints into <output_dir>/best; returns {"steps",
    "epoch", "n_params"}. `steps` (epochs) wins over `last` (the newest N);
    by default every rolling checkpoint the run kept."""
    cfg = load_checkpoint_config(checkpoint_dir)
    if cfg is None:
        raise FileNotFoundError(f"no checkpoint config under {checkpoint_dir}")
    files = dict(epoch_files(Path(checkpoint_dir).absolute() / "rolling"))
    available = sorted(files)
    if not available:
        raise FileNotFoundError(
            f"no rolling checkpoints under {checkpoint_dir} — SWA averages rolling "
            "(raw-weight) checkpoints; train with train.save_every_n_epochs to produce them")
    if steps is not None:
        sel = sorted(int(s) for s in steps)
        missing = [s for s in sel if s not in files]
        if missing:
            raise ValueError(f"rolling steps {missing} not found; available: {available}")
    else:
        sel = available if last is None else available[-int(last):]
    if len(sel) < 2:
        raise ValueError(f"SWA needs >= 2 checkpoints; selected {sel} (available: {available})")

    blobs = [torch.load(files[s], map_location="cpu", weights_only=True) for s in sel]
    newest = blobs[-1]
    meta = {**newest["meta"], "swa_sources": sel}
    epoch = int(newest["epoch"])
    save_checkpoint(Path(output_dir) / "best" / f"epoch_{epoch:04d}.pt",
                    mean_state_dicts([b["state_dict"] for b in blobs]), cfg, epoch,
                    newest["optimizer"], int(newest["step"]), meta)
    model = build_model(cfg.model, cfg.grid, device="cpu", seed=None,
                        in_channels=feature_channels(cfg.features.feature_set,
                                                     cfg.model.n_channels))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("SWA: averaged rolling epochs %s -> %s/best (epoch %d)", sel, output_dir, epoch)
    return {"steps": sel, "epoch": epoch, "n_params": n_params}
