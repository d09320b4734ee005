"""On-disk corpus cache (counterpart: seld_tpu/data/cache.py).

A finished WindowedCorpus is stored as one .npz keyed on the inputs that
determine it: the ordered file lists (resolved path, size, mtime), the
feature, grid, window and target configs and the train flag. Any change
of a file or a knob gives another key (targets.accdoa and
targets.accdoa_tracks among them, so a grid-only entry never serves an
ACCDOA request); an entry built with ACCDOA targets stores them too. The key also holds this package's
tag and its own format version, so a cache directory that a JAX run
filled is never read as the port's: the two packages' features differ by
up to 5e-3 dB, and the JAX corpus has fields the port's lacks.

`data.cache_dir` turns it on (empty: off). A write goes to a temporary
file that is renamed into place, so runs sharing a directory never see a
torn file; an unreadable or corrupt entry is rebuilt, and a failed store
only warns.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from seld_tpu_torch import resolve_device
from seld_tpu_torch.config import FeatureConfig, GridConfig, TargetConfig, WindowConfig
from seld_tpu_torch.data.corpus import WindowedCorpus, build_corpus

logger = logging.getLogger(__name__)

PACKAGE_TAG = "seld_tpu_torch"
# Bump whenever the contents or meaning of a stored corpus change, so that
# old entries stop matching.
CACHE_FORMAT_VERSION = 1


def _file_sig(path) -> list:
    st = os.stat(path)
    return [str(Path(path).resolve()), st.st_size, st.st_mtime_ns]


def corpus_cache_key(audio_files, metadata_files, feat: FeatureConfig, grid: GridConfig,
                     window: WindowConfig, targets: TargetConfig, train: bool) -> str:
    """Hex digest of one corpus build's inputs."""
    key = {
        "package": PACKAGE_TAG,
        "version": CACHE_FORMAT_VERSION,
        "audio": [_file_sig(p) for p in audio_files],
        "metadata": [_file_sig(p) for p in metadata_files],
        "features": dataclasses.asdict(feat),
        "grid": dataclasses.asdict(grid),
        "window": dataclasses.asdict(window),
        "targets": dataclasses.asdict(targets),
        "train": bool(train),
    }
    blob = json.dumps(key, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


def _save_corpus(path: Path, corpus: WindowedCorpus, key: str) -> None:
    meta = {
        "key": key,
        "window_frames": corpus.window_frames,
        "total_frames": corpus.total_frames,
        "n_el": corpus.n_el,
        "n_az": corpus.n_az,
        "num_classes": corpus.num_classes,
    }
    arrays = dict(mel=corpus.mel, label_mask=corpus.label_mask, starts=corpus.starts,
                  meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    if corpus.accdoa is not None:
        arrays["accdoa"] = corpus.accdoa
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_corpus(path: Path, key: str) -> WindowedCorpus:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["key"] != key:  # a digest-prefix collision
            raise ValueError("cache key mismatch")
        return WindowedCorpus(
            mel=z["mel"], label_mask=z["label_mask"], starts=z["starts"],
            window_frames=int(meta["window_frames"]),
            total_frames=int(meta["total_frames"]),
            n_el=int(meta["n_el"]), n_az=int(meta["n_az"]),
            num_classes=int(meta["num_classes"]),
            accdoa=z["accdoa"] if "accdoa" in z.files else None,
        )


def cached_build_corpus(audio_files, metadata_files, feat: FeatureConfig, grid: GridConfig,
                        window: WindowConfig, targets: TargetConfig, train: bool = True,
                        cache_dir: str = "",
                        device: str | torch.device | None = None) -> WindowedCorpus:
    """build_corpus with an optional on-disk cache: with cache_dir empty
    it is build_corpus; else a hit loads the stored arrays (equal to a
    fresh build: the build is deterministic, the Gaussian labels
    included) and a miss builds on `device` and stores."""
    device = resolve_device(device)  # before anything is read or written
    if not cache_dir:
        return build_corpus(audio_files, metadata_files, feat, grid, window, targets,
                            train=train, device=device)
    cdir = Path(cache_dir)
    cdir.mkdir(parents=True, exist_ok=True)
    key = corpus_cache_key(audio_files, metadata_files, feat, grid, window, targets, train)
    path = cdir / f"corpus_{key}.npz"
    if path.exists():
        try:
            corpus = _load_corpus(path, key)
            logger.info("Corpus cache hit: %s (%d windows, %d frames)",
                        path, len(corpus), corpus.total_frames)
            return corpus
        except Exception as e:  # a corrupt, torn or foreign file: rebuild
            logger.warning("Corpus cache %s unreadable (%s); rebuilding", path, e)
    corpus = build_corpus(audio_files, metadata_files, feat, grid, window, targets,
                          train=train, device=device)
    try:
        _save_corpus(path, corpus, key)
        logger.info("Corpus cache stored: %s", path)
    except Exception as e:  # a read-only directory, a full disk, ...
        logger.warning("Corpus cache store failed (%s); continuing uncached", e)
    return corpus
