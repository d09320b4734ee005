"""Checkpoints: one file per checkpoint, a best one and rolling ones, and
resume (counterpart: seld_tpu/train/checkpoint.py).

A file is a torch.save of {"config", "state_dict", "epoch", "optimizer",
"step", "meta"}: the full config dict (so that a reader rebuilds the exact
architecture), the model's state_dict, the optimizer's state_dict (None
for a weights-only file), the step counter, and meta with the epoch and
its losses. Loading uses weights_only=True, so a file holds tensors and
plain data only. A file is written under a temporary name and renamed, so
a save that is interrupted leaves the previous file whole. Saves are
synchronous: there is nothing to wait for or to close.

`CheckpointManager` keeps <dir>/best/epoch_NNNN.pt (one file: the lowest
test loss so far, or the best `train.select_metric`) and <dir>/rolling/epoch_NNNN.pt (the newest
`keep_last_n_checkpoints`). Any of these files serves through
`SELDPredictor`.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch
from torch import nn

from seld_tpu_torch.config import Config, config_from_dict, config_to_dict
from seld_tpu_torch.train.state import TrainState


def _to_cpu(obj):
    """Tensors of a nested state_dict, detached and on the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path, model: nn.Module | dict, cfg: Config, epoch: int = 0,
                    optimizer: torch.optim.Optimizer | dict | None = None, step: int = 0,
                    meta: dict | None = None) -> None:
    """Write `model` (a module or a state_dict), `cfg` and, for a file to
    resume from, the optimizer (or its state_dict) and step counter to
    `path`."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    if optimizer is not None and not isinstance(optimizer, dict):
        optimizer = optimizer.state_dict()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(
        {
            "config": config_to_dict(cfg),
            "state_dict": _to_cpu(state),
            "epoch": int(epoch),
            "optimizer": _to_cpu(optimizer),
            "step": int(step),
            "meta": dict(meta or {}),
        },
        tmp,
    )
    os.replace(tmp, path)


def load_checkpoint(path) -> tuple[Config, dict[str, torch.Tensor], int]:
    """-> (config, state_dict on the CPU, epoch)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return config_from_dict(blob["config"]), blob["state_dict"], int(blob["epoch"])


def epoch_files(directory: Path) -> list[tuple[int, Path]]:
    """(epoch, file) of every checkpoint in `directory`, oldest first."""
    found = []
    for f in directory.glob("epoch_*.pt"):
        try:
            found.append((int(f.stem.split("_")[1]), f))
        except ValueError:
            continue
    return sorted(found)


class CheckpointManager:
    """Best and rolling checkpoints of one training run under `directory`."""

    def __init__(self, directory, cfg: Config):
        self.directory = Path(directory).absolute()
        self.cfg = cfg
        self.best_dir = self.directory / "best"
        self.rolling_dir = self.directory / "rolling"
        for d in (self.best_dir, self.rolling_dir):
            d.mkdir(parents=True, exist_ok=True)

    def _save(self, directory: Path, keep: int, epoch: int, state: TrainState,
              train_loss: float, test_loss: float, select: dict | None = None) -> Path:
        path = directory / f"epoch_{epoch:04d}.pt"
        meta = {"epoch": int(epoch), "train_loss": float(train_loss),
                "test_loss": float(test_loss)}
        if select is not None:
            # {"metric": train.select_metric, "value": float}: a resumed run
            # takes its best-so-far selection value from here
            meta["select"] = select
        save_checkpoint(path, state.model, self.cfg, epoch, state.optimizer,
                        state.step, meta)
        others = [f for _, f in epoch_files(directory) if f != path]
        for stale in others[:max(len(others) - (keep - 1), 0)]:
            stale.unlink()
        return path

    def save_best(self, epoch: int, state: TrainState, train_loss, test_loss,
                  select: dict | None = None) -> Path:
        return self._save(self.best_dir, 1, epoch, state, train_loss, test_loss, select)

    def save_rolling(self, epoch: int, state: TrainState, train_loss, test_loss) -> Path:
        return self._save(self.rolling_dir, self.cfg.train.keep_last_n_checkpoints,
                          epoch, state, train_loss, test_loss)

    def best_path(self) -> Path | None:
        files = epoch_files(self.best_dir)
        return files[-1][1] if files else None

    def best_meta(self) -> dict | None:
        """meta of the stored best checkpoint, or None."""
        path = self.best_path()
        if path is None:
            return None
        return torch.load(path, map_location="cpu", weights_only=True)["meta"]

    @staticmethod
    def _restore(files: list[tuple[int, Path]], state: TrainState):
        if not files:
            return None
        blob = torch.load(files[-1][1], map_location="cpu", weights_only=True)
        state.model.load_state_dict(blob["state_dict"])
        if state.optimizer is not None and blob["optimizer"] is not None:
            state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        return state, blob["meta"]

    def restore_best(self, state: TrainState):
        """Load the best checkpoint into `state` -> (state, meta) or None."""
        return self._restore(epoch_files(self.best_dir), state)

    def restore_latest(self, state: TrainState):
        """Resume point: load the newest rolling checkpoint into `state`
        (weights, optimizer moments and learning rate, step counter)
        -> (state, meta) or None."""
        return self._restore(epoch_files(self.rolling_dir), state)


def checkpoint_file(directory, kind: str) -> Path | None:
    """The newest file of a run's "best" or "latest" (rolling) checkpoints,
    or None; creates nothing."""
    sub = {"best": "best", "latest": "rolling"}[kind]
    files = epoch_files(Path(directory).absolute() / sub)
    return files[-1][1] if files else None


def load_checkpoint_config(directory) -> Config | None:
    """The config stored inside a run's checkpoint tree."""
    directory = Path(directory).absolute()
    for sub in ("best", "rolling"):
        files = epoch_files(directory / sub)
        if files:
            return load_checkpoint(files[-1][1])[0]
    return None
