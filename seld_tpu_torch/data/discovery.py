"""Dataset file discovery: WAV clips paired with CSV metadata by basename
(counterpart: seld_tpu/data/discovery.py).

Full-dataset mode globs *.wav in the four Sony/TAU split directories
(sorted) and requires a same-stem .csv in the matching metadata
directory; single-file mode pins one train and one test clip.
"""

from __future__ import annotations

from pathlib import Path

from seld_tpu_torch.config import DataConfig


def _match_metadata(audio_files: list[str], meta_dir: Path) -> list[str]:
    meta = []
    for f in audio_files:
        candidate = meta_dir / f"{Path(f).stem}.csv"
        if not candidate.exists():
            raise FileNotFoundError(f"Metadata file not found: {candidate}")
        meta.append(str(candidate))
    return meta


def discover_files(cfg: DataConfig):
    """-> (train_audio, train_meta, test_audio, test_meta) path lists."""
    if cfg.use_full_dataset:
        out = {}
        for split in ("train", "test"):
            audio, meta = [], []
            for audio_dir, meta_dir in cfg.split_dirs(split):
                wavs = sorted(str(p) for p in Path(audio_dir).glob("*.wav"))
                audio.extend(wavs)
                meta.extend(_match_metadata(wavs, Path(meta_dir)))
            out[split] = (audio, meta)
        return (*out["train"], *out["test"])

    train_audio = [str(cfg.audio_path / "dev-train-sony" / cfg.train_audio_file)]
    train_meta = [str(cfg.metadata_path / "dev-train-sony" / cfg.train_meta_file)]
    test_audio = [str(cfg.audio_path / "dev-test-sony" / cfg.test_audio_file)]
    test_meta = [str(cfg.metadata_path / "dev-test-sony" / cfg.test_meta_file)]
    return train_audio, train_meta, test_audio, test_meta
