"""Synthetic SELD data: FOA-panned tone clips with matching metadata
(counterpart: seld_tpu/data/synthetic.py). The generator is numpy and
draws in the same order as the JAX package's, so the same seed gives the
same clips and metadata rows. It stands in for STARSS22 in tests, smoke
training and `cli train --synthetic`.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from seld_tpu_torch.config import Config
from seld_tpu_torch.data.audio import write_wav
from seld_tpu_torch.data.corpus import WindowedCorpus, build_corpus


def foa_gains(az_deg, el_deg) -> np.ndarray:
    """SN3D first-order ambisonic panning gains in STARSS22's ACN channel
    order (W, Y, Z, X) for a plane wave from (az, el) degrees. Scalars ->
    (4,), equal-shape arrays -> (4, *shape)."""
    az = np.asarray(np.deg2rad(az_deg), np.float32)
    el = np.asarray(np.deg2rad(el_deg), np.float32)
    return np.stack([
        np.ones_like(az),
        np.sin(az) * np.cos(el),
        np.sin(el),
        np.cos(az) * np.cos(el),
    ]).astype(np.float32)


def _wrap_az(az):
    """Wrap azimuth(s) to [-180, 180) degrees."""
    return (np.asarray(az) + 180.0) % 360.0 - 180.0


def _reflect(x, lo: float, hi: float):
    """Reflect value(s) into [lo, hi] (a triangle wave): elevation
    trajectories bounce off the caps instead of crossing the poles."""
    span = hi - lo
    y = (np.asarray(x, np.float64) - lo) % (2.0 * span)
    return lo + np.where(y > span, 2.0 * span - y, y)


def synthetic_clip(rng, seconds: float, sample_rate: int, n_channels: int = 4,
                   doa_step_deg: int | None = None,
                   event_rate_hz: float | None = None,
                   motion_deg_per_s: float | None = None):
    """A clip of FOA-panned tones over noise, and its metadata rows
    (frame at 100 ms, class, source, azimuth, elevation).

    Each event's tone is panned onto the 4 channels with the SN3D gains of
    its labelled direction, and each class has its own fundamental, so both
    detection and localization are learnable. Other channel counts get
    random gains.

    doa_step_deg: draw az/el from multiples of this step (el within
    [-60, 60]) instead of uniformly. event_rate_hz: expected events per
    second; None keeps 2-8 events per clip. motion_deg_per_s: sources move
    at a constant angular velocity; the audio is panned per sample along
    the trajectory, the rows carry the direction at each metadata frame's
    midpoint, azimuth wraps at the dateline and elevation reflects off the
    caps.
    """
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    wave = 0.01 * rng.standard_normal((n_channels, n)).astype(np.float32)
    if event_rate_hz is None:
        n_events = rng.integers(2, 8)
    else:
        n_events = max(1, int(round(seconds * event_rate_hz)))
    rows = []
    for _ in range(n_events):
        cls = int(rng.integers(0, 13))
        f0 = 220.0 * (2.0 ** (cls / 3.0)) * rng.uniform(0.98, 1.02)
        start_s = rng.uniform(0, max(seconds - 1.0, 0.1))
        dur_s = rng.uniform(0.3, 1.5)
        src = int(rng.integers(0, 3))
        if doa_step_deg is not None:
            step = int(doa_step_deg)
            az = int(rng.choice(np.arange(-180, 180, step)))
            el_max = (60 // step) * step
            el = int(rng.choice(np.arange(-el_max, el_max + 1, step)))
        else:
            az = int(rng.integers(-180, 180))
            el = int(rng.integers(-90, 91))
        s0, s1 = int(start_s * sample_rate), min(int((start_s + dur_s) * sample_rate), n)
        tone = 0.3 * np.sin(2 * np.pi * f0 * t[s0:s1]).astype(np.float32)
        tone += 0.1 * np.sin(2 * np.pi * 2 * f0 * t[s0:s1]).astype(np.float32)
        if motion_deg_per_s is not None:
            speed = motion_deg_per_s * rng.uniform(0.8, 1.2)
            theta = rng.uniform(0.0, 2.0 * np.pi)
            v_az, v_el = speed * np.cos(theta), speed * np.sin(theta)
            el_cap = float((60 // int(doa_step_deg)) * int(doa_step_deg)
                           if doa_step_deg is not None else 85)

            def angles_at(rel_t):
                return (_wrap_az(az + v_az * rel_t),
                        _reflect(el + v_el * rel_t, -el_cap, el_cap))
        else:
            def angles_at(rel_t):
                shape = np.shape(rel_t)
                return (np.full(shape, float(az)), np.full(shape, float(el)))
        if n_channels == 4:
            if motion_deg_per_s is not None:
                az_t, el_t = angles_at(np.arange(s1 - s0) / sample_rate)
                gains = foa_gains(az_t, el_t)  # (4, s1-s0): panned per sample
            else:
                gains = foa_gains(az, el)[:, None]
        else:
            gains = rng.uniform(0.3, 1.0, (n_channels, 1)).astype(np.float32)
        wave[:, s0:s1] += tone * gains
        for meta_frame in range(int(start_s * 10), int((start_s + dur_s) * 10)):
            rel_mid = np.clip((meta_frame + 0.5) / 10.0 - start_s, 0.0, dur_s)
            az_mf, el_mf = angles_at(rel_mid)
            rows.append((meta_frame, cls, src,
                         int(round(float(az_mf))), int(round(float(el_mf)))))
    # a uniform rescale keeps the channel ratios where the 16-bit WAV
    # would otherwise clip
    peak = float(np.max(np.abs(wave)))
    if peak > 0.99:
        wave *= np.float32(0.99 / peak)
    rows.sort()
    return wave, np.asarray(rows, dtype=np.int64).reshape(-1, 5)


def synthetic_raw_files(root: Path, cfg: Config, n_files: int = 2, seconds: float = 12.0,
                        seed: int = 0, split_dirs: bool = False,
                        doa_step_deg: int | None = None,
                        event_rate_hz: float | None = None,
                        motion_deg_per_s: float | None = None):
    """Write synthetic (wav, csv) pairs under `root`; split_dirs=True lays
    out the STARSS22 directory structure. -> (audio_files, meta_files)."""
    rng = np.random.default_rng(seed)
    audio_files, meta_files = [], []
    for i in range(n_files):
        wave, rows = synthetic_clip(rng, seconds, cfg.features.sample_rate,
                                    doa_step_deg=doa_step_deg,
                                    event_rate_hz=event_rate_hz,
                                    motion_deg_per_s=motion_deg_per_s)
        if split_dirs:
            sub = "dev-train-sony" if i % 2 == 0 else "dev-train-tau"
            apath = root / cfg.data.audio_dirname / sub / f"fold3_room1_mix{i:03d}.wav"
            mpath = root / cfg.data.metadata_dirname / sub / f"fold3_room1_mix{i:03d}.csv"
        else:
            apath = root / f"clip{i:03d}.wav"
            mpath = root / f"clip{i:03d}.csv"
        write_wav(apath, wave, cfg.features.sample_rate)
        mpath.parent.mkdir(parents=True, exist_ok=True)
        np.savetxt(mpath, rows, fmt="%d", delimiter=",")
        audio_files.append(str(apath))
        meta_files.append(str(mpath))
    return audio_files, meta_files


def synthetic_corpus(cfg: Config, n_files: int = 2, seconds: float = 12.0, seed: int = 0,
                     train: bool = True, doa_step_deg: int | None = None,
                     event_rate_hz: float | None = None,
                     motion_deg_per_s: float | None = None,
                     device: str | torch.device | None = None) -> WindowedCorpus:
    """A WindowedCorpus of synthetic clips, written to a temporary
    directory and read back through build_corpus (features on `device`)."""
    with tempfile.TemporaryDirectory() as td:
        audio_files, meta_files = synthetic_raw_files(
            Path(td), cfg, n_files=n_files, seconds=seconds, seed=seed,
            doa_step_deg=doa_step_deg, event_rate_hz=event_rate_hz,
            motion_deg_per_s=motion_deg_per_s,
        )
        return build_corpus(audio_files, meta_files, cfg.features, cfg.grid,
                            cfg.window, cfg.targets, train=train, device=device)
