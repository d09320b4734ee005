"""Whether a training stage finished (counterpart:
seld_tpu/train/completion.py).

`train_model` returns cleanly when a SIGTERM lands mid-run: it saves a
checkpoint and leaves the epoch loop with `history["preempted_epoch"]`
set, and a non-finite loss leaves it with `history["aborted_epoch"]`.
That is right for a later `resume=True`, and a trap for anything that
reads "train_model returned" as "training finished". This module is the
one place that knows the difference: `training_completed` and
`incomplete_reason` read a history, `workdir_incomplete_reason` reads the
training_history.json of a checkpoint tree (`evaluate_model` stamps its
report with it), and `run_training_stage` trains one stage of a study and
writes its train_done.json marker only for a run that finished.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

logger = logging.getLogger(__name__)

MARKER_NAME = "train_done.json"


class IncompleteTrainingError(RuntimeError):
    """A training stage returned without completing its epoch budget
    (preemption, or an abort on a non-finite loss)."""


def training_completed(history: dict) -> bool:
    """True iff the history describes a run that finished its epochs."""
    return "preempted_epoch" not in history and "aborted_epoch" not in history


def incomplete_reason(history: dict) -> dict | None:
    """None for a complete run, else {"preempted_epoch": N} or
    {"aborted_epoch": N}."""
    for key in ("preempted_epoch", "aborted_epoch"):
        if key in history:
            return {key: int(history[key])}
    return None


def workdir_incomplete_reason(workdir) -> dict | None:
    """`incomplete_reason` of the training_history.json under a checkpoint
    tree; None when the file is absent, unreadable or complete (a
    checkpoint made elsewhere has no history, which is no error)."""
    hist_path = Path(workdir) / "training_history.json"
    if not hist_path.exists():
        return None
    try:
        history = json.loads(hist_path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return incomplete_reason(history)


def run_training_stage(cfg, train_corpus, test_corpus, workdir, *, train_fn=None,
                       marker_extra: dict | None = None, device=None):
    """Train one study stage and write its completion marker; returns the
    marker dict.

    An existing marker is reused, so an interrupted multi-stage study
    resumes without retraining finished stages; a marker without a
    "completed" stamp is refused. The marker is written only when
    `training_completed(history)`: otherwise the stage raises
    `IncompleteTrainingError`, and a rerun resumes it from its own
    checkpoints (`resume=True` when the tree has any). `train_fn` defaults
    to `train_model` on `device`."""
    workdir = Path(workdir)
    marker = workdir / MARKER_NAME
    if marker.exists():
        info = json.loads(marker.read_text())
        if not info.get("completed"):
            raise IncompleteTrainingError(
                f"{workdir}: stale completion marker without a 'completed' stamp "
                f"({info}): it cannot tell a preempted run from a finished one. "
                f"Delete {marker} (and the checkpoint tree, unless resuming "
                f"deliberately) and rerun."
            )
        logger.info("%s: reusing trained state (%s)", workdir.name, info)
        return info

    if train_fn is None:
        from seld_tpu_torch.train.trainer import train_model

        def train_fn(*args, **kwargs):
            return train_model(*args, device=device, **kwargs)

    resume = (workdir / "rolling").exists() or (workdir / "best").exists()
    t0 = time.time()
    state, history = train_fn(cfg, train_corpus, test_corpus, workdir=workdir, resume=resume)
    reason = incomplete_reason(history)
    if reason is not None:
        raise IncompleteTrainingError(
            f"{workdir.name}: training truncated ({reason}): no completion marker "
            f"written; rerun the study to resume this stage from its checkpoint."
        )
    from seld_tpu_torch.train.state import param_count

    info = {
        "completed": True,
        "seconds": round(time.time() - t0),
        "params": int(param_count(state)),
        "epochs": len(history.get("train_losses", [])),
        "resumed": bool(resume),
        **(marker_extra or {}),
    }
    marker.write_text(json.dumps(info) + "\n")
    logger.info("%s: trained in %ds (%s params)", workdir.name, info["seconds"],
                f"{info['params']:,}")
    return info
