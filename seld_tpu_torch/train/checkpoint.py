"""Checkpoints: one file per checkpoint, a best one and rolling ones, and
resume (counterpart: seld_tpu/train/checkpoint.py).

A file is a torch.save of {"config", "state_dict", "epoch", "optimizer",
"step", "meta"}: the full config dict (so that a reader rebuilds the exact
architecture), the model's state_dict, the optimizer's state_dict (None
for a weights-only file), the step counter, and meta with the epoch and
its losses. Loading uses weights_only=True, so a file holds tensors and
plain data only. Tensors are written in their own dtype: bf16 parameters
and Adam moments (model.param_dtype=bfloat16) as bf16, BatchNorm
statistics as float32; a file rebuilds its model from its own config, so
it reads back in that dtype. A file is written under a temporary name and
renamed, so a save that is interrupted leaves the previous file whole.

`CheckpointManager` keeps <dir>/best/epoch_NNNN.pt (one file: the lowest
test loss so far, or the best `train.select_metric`) and <dir>/rolling/epoch_NNNN.pt (the newest
`keep_last_n_checkpoints`). Any of these files serves through
`SELDPredictor`. Its saves run in the background, as the JAX package's
orbax managers do: `save_best` / `save_rolling` copy the model's and the
optimizer's tensors to host memory (device tensors into pinned buffers,
then one synchronisation, so the next optimizer step cannot change what is
written) and return; one worker thread writes, renames and rotates, in
the order of the calls. `wait()` blocks until every save so far is on
disk and `close()` also stops the worker. The readers (`best_path`,
`best_meta`, `restore_best`, `restore_latest`, and the module's
`checkpoint_file` and `load_checkpoint_config` for a directory a live
manager writes) wait first. An exception of the worker is raised by the
next `save_*`, `wait` or `close`.
"""

from __future__ import annotations

import os
import threading
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import torch
from torch import nn

from seld_tpu_torch.config import Config, config_from_dict, config_to_dict
from seld_tpu_torch.train.state import TrainState

# the managers of this process, so that a module-level reader of a
# directory waits for the writes a manager still has in flight
_MANAGERS: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


def _to_host(obj, copies: list):
    """The tensors of a nested state_dict as host copies that later
    in-place updates cannot reach: a device tensor goes into a pinned host
    buffer without blocking (its device appended to `copies`: synchronise
    before reading), a CPU tensor is cloned."""
    if torch.is_tensor(obj):
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        copies.append(t.device)
        return host
    if isinstance(obj, dict):
        return {k: _to_host(v, copies) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, copies) for v in obj)
    return obj


def _snapshot(model: nn.Module | dict, cfg: Config, epoch: int,
              optimizer: torch.optim.Optimizer | dict | None, step: int,
              meta: dict | None) -> dict:
    """The file's dict, its tensors on the host (one synchronisation a
    device), so that the next optimizer step cannot change what is
    written."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    if optimizer is not None and not isinstance(optimizer, dict):
        optimizer = optimizer.state_dict()
    copies: list = []
    blob = {
        "config": config_to_dict(cfg),
        "state_dict": _to_host(state, copies),
        "epoch": int(epoch),
        "optimizer": _to_host(optimizer, copies),
        "step": int(step),
        "meta": dict(meta or {}),
    }
    for device in set(copies):
        torch.cuda.synchronize(device)
    return blob


def _write(path: Path, blob: dict) -> None:
    """torch.save to a temporary name beside `path`, then the rename; a
    write that fails removes its temporary file and leaves `path` as it
    was."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        torch.save(blob, tmp)
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def save_checkpoint(path, model: nn.Module | dict, cfg: Config, epoch: int = 0,
                    optimizer: torch.optim.Optimizer | dict | None = None, step: int = 0,
                    meta: dict | None = None) -> None:
    """Write `model` (a module or a state_dict), `cfg` and, for a file to
    resume from, the optimizer (or its state_dict) and step counter to
    `path`, before returning."""
    _write(Path(path), _snapshot(model, cfg, epoch, optimizer, step, meta))


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
    """Best and rolling checkpoints of one training run under `directory`,
    written in the background (see the module's note)."""

    def __init__(self, directory, cfg: Config):
        self.directory = Path(directory).absolute()
        self.cfg = cfg
        self.best_dir = self.directory / "best"
        self.rolling_dir = self.directory / "rolling"
        for d in (self.best_dir, self.rolling_dir):
            d.mkdir(parents=True, exist_ok=True)
        self._worker: ThreadPoolExecutor | None = None  # made by the first save
        self._pending: list[Future] = []
        self._closed = False
        _MANAGERS.add(self)

    def _settle(self, block: bool) -> None:
        """Drop the finished writes, raising the first one's exception;
        with `block`, wait for all of them first."""
        # one worker: the writes finish in the order they were queued
        while self._pending and (block or self._pending[0].done()):
            self._pending.pop(0).result()

    def _write_and_rotate(self, path: Path, blob: dict, keep: int) -> None:
        _write(path, blob)
        others = [f for _, f in epoch_files(path.parent) if f != path]
        for stale in others[:max(len(others) - (keep - 1), 0)]:
            stale.unlink()

    def _save(self, directory: Path, keep: int, epoch: int, state: TrainState,
              train_loss: float, test_loss: float, select: dict | None = None) -> Path:
        if self._closed:
            raise RuntimeError(f"CheckpointManager({self.directory}) is closed")
        self._settle(block=False)
        path = directory / f"epoch_{epoch:04d}.pt"
        meta = {"epoch": int(epoch), "train_loss": float(train_loss),
                "test_loss": float(test_loss)}
        if select is not None:
            # {"metric": train.select_metric, "value": float}: a resumed run
            # takes its best-so-far selection value from here
            meta["select"] = select
        blob = _snapshot(state.model, self.cfg, epoch, state.optimizer, state.step, meta)
        if self._worker is None:
            self._worker = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="checkpoint-writer")
        self._pending.append(self._worker.submit(self._write_and_rotate, path, blob, keep))
        return path

    def save_best(self, epoch: int, state: TrainState, train_loss, test_loss,
                  select: dict | None = None) -> Path:
        """Snapshot `state` and queue its write as the one best checkpoint;
        returns the file's path (on disk after `wait()`)."""
        return self._save(self.best_dir, 1, epoch, state, train_loss, test_loss, select)

    def save_rolling(self, epoch: int, state: TrainState, train_loss, test_loss) -> Path:
        """Snapshot `state` and queue its write as a rolling checkpoint (the
        newest keep_last_n_checkpoints stay); returns the file's path."""
        return self._save(self.rolling_dir, self.cfg.train.keep_last_n_checkpoints,
                          epoch, state, train_loss, test_loss)

    def wait(self) -> None:
        """Block until every queued save is on disk; raises the first
        failed write's exception."""
        self._settle(block=True)

    def close(self) -> None:
        """wait(), then stop the writer thread; later saves raise."""
        try:
            self.wait()
        finally:
            self._closed = True
            if self._worker is not None:
                self._worker.shutdown(wait=True)
                self._worker = None

    def best_path(self) -> Path | None:
        self.wait()
        files = epoch_files(self.best_dir)
        return files[-1][1] if files else None

    def best_meta(self) -> dict | None:
        """meta of the stored best checkpoint, or None."""
        path = self.best_path()
        if path is None:
            return None
        return torch.load(path, map_location="cpu", weights_only=True)["meta"]

    def _restore(self, directory: Path, state: TrainState):
        self.wait()
        files = epoch_files(directory)
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
        return self._restore(self.best_dir, state)

    def restore_latest(self, state: TrainState):
        """Resume point: load the newest rolling checkpoint into `state`
        (weights, optimizer moments and learning rate, step counter)
        -> (state, meta) or None."""
        return self._restore(self.rolling_dir, state)


def _wait_for_writers(directory: Path) -> None:
    """Wait for the live managers of this process that write under
    `directory`."""
    for manager in list(_MANAGERS):
        if manager.directory == directory and not manager._closed:
            manager.wait()


def checkpoint_file(directory, kind: str) -> Path | None:
    """The newest file of a run's "best" or "latest" (rolling) checkpoints,
    or None; creates nothing."""
    sub = {"best": "best", "latest": "rolling"}[kind]
    directory = Path(directory).absolute()
    _wait_for_writers(directory)
    files = epoch_files(directory / sub)
    return files[-1][1] if files else None


def load_checkpoint_config(directory) -> Config | None:
    """The config stored inside a run's checkpoint tree."""
    directory = Path(directory).absolute()
    _wait_for_writers(directory)
    for sub in ("best", "rolling"):
        files = epoch_files(directory / sub)
        if files:
            return load_checkpoint(files[-1][1])[0]
    return None
