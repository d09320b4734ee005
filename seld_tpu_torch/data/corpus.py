"""Waveform -> features, and files -> a windowed corpus (counterpart:
seld_tpu/data/corpus.py).

Framing is a strided view of the reflect-padded signal on the device,
and the kernels read that view in place, in one launch per clip: K1
(seld_tpu_torch.ops.mel_cuda) for feature_set "mel", K4
(seld_tpu_torch.ops.spatial_cuda) for "mel_iv" and "mel_gcc". Both
kernels treat every frame on its own: the JAX package's 128/1024/8192
frame tiers exist for XLA's static shapes and have no counterpart here.

A corpus keeps its features and its (T, G) uint16 label bitmasks (and,
with targets.accdoa, its ACCDOA targets) as numpy arrays on the host,
concatenated over the files; windows are start offsets into them, not
copies. The last window is padded with zero features, background labels
and zero ACCDOA targets.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from seld_tpu_torch import resolve_device
from seld_tpu_torch.accdoa import rasterize_accdoa_targets, rasterize_adpit_targets
from seld_tpu_torch.config import FeatureConfig, GridConfig, TargetConfig, WindowConfig
from seld_tpu_torch.data.audio import load_wav
from seld_tpu_torch.features.mel import frame_signal
from seld_tpu_torch.ops.mel_cuda import log_mel_frames
from seld_tpu_torch.ops.spatial_cuda import spatial_features
from seld_tpu_torch.targets.gaussian import rasterize_gaussian_labels
from seld_tpu_torch.targets.rasterize import (
    encode_events_to_bitmask,
    load_metadata_csv,
    total_label_frames,
)

logger = logging.getLogger(__name__)


def compute_mel_features(wave, feat: FeatureConfig,
                         device: str | torch.device | None = None) -> torch.Tensor:
    """(C, N) waveform (numpy or tensor) -> (T, C_out, n_mels) float32
    features on `device` (CUDA unless named), T = 1 + N // hop."""
    device = resolve_device(device)
    if not torch.is_tensor(wave):
        wave = torch.from_numpy(np.asarray(wave, np.float32))
    x = wave.to(device=device, dtype=torch.float32)
    return features_from_frames(frame_signal(x, feat.n_fft, feat.hop_length), feat)


def features_from_frames(frames: torch.Tensor, feat: FeatureConfig) -> torch.Tensor:
    """(C, T, n_fft) frames -> (T, C_out, n_mels) features, time-major so
    that window slicing is a view of the leading axis: C_out = C log-mel
    planes for "mel", 7 or 10 planes of 4 channels for "mel_iv" /
    "mel_gcc"."""
    if feat.feature_set != "mel":  # an unknown set raises in spatial_features
        return spatial_features(frames, feat.feature_set, n_mels=feat.n_mels,
                                sample_rate=feat.sample_rate, amin=feat.amin)
    out = log_mel_frames(frames, n_fft=feat.n_fft, n_mels=feat.n_mels,
                         sample_rate=feat.sample_rate, f_min=feat.f_min,
                         f_max=feat.f_max, amin=feat.amin)  # (C, T, n_mels)
    return out.transpose(0, 1).contiguous()


@dataclass
class WindowedCorpus:
    """Concatenated corpus and its window index table.

    mel:        (T_pad, C, n_mels) float32
    label_mask: (T_pad, G) uint16 class bitmask (0 == background)
    starts:     (W,) int32 window start frames
    accdoa:     (T_pad, M - 1, 3) single-ACCDOA or (T_pad, 6, 4, M - 1)
                ADPIT targets per targets.accdoa_tracks, or None
    """

    mel: np.ndarray
    label_mask: np.ndarray
    starts: np.ndarray
    window_frames: int
    total_frames: int  # before padding
    n_el: int
    n_az: int
    num_classes: int
    accdoa: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.starts)

    def _offsets(self, idxs: np.ndarray) -> np.ndarray:
        return self.starts[np.asarray(idxs)][:, None] + np.arange(self.window_frames)

    def gather(self, idxs: np.ndarray):
        """Windows idxs -> (B, win, C, F) float32, (B, win, G) uint16."""
        offs = self._offsets(idxs)
        return self.mel[offs], self.label_mask[offs]

    def gather_accdoa(self, idxs: np.ndarray) -> np.ndarray:
        """Windows idxs -> (B, win, ...) float32 ACCDOA targets (a corpus
        built with targets.accdoa)."""
        if self.accdoa is None:
            raise ValueError("the corpus was built without ACCDOA targets "
                             "(targets.accdoa=false)")
        return self.accdoa[self._offsets(idxs)]


def build_corpus(audio_files, metadata_files, feat: FeatureConfig, grid: GridConfig,
                 window: WindowConfig, targets: TargetConfig, train: bool = True,
                 device: str | torch.device | None = None) -> WindowedCorpus:
    """Load every (wav, csv) pair, compute its features on `device` (CUDA
    unless named: kernel K1 or K4) and its label bitmask, crop both to their
    common length, concatenate, pad and index the windows. With train and
    targets.use_gaussian_augmentation the labels are Gaussian regions,
    keyed on each file's index in the list. With targets.accdoa the
    ACCDOA (or, above one track, ADPIT) targets are built beside them from
    the same rows."""
    device = resolve_device(device)
    if len(audio_files) != len(metadata_files):
        raise ValueError(
            f"{len(audio_files)} audio files but {len(metadata_files)} metadata files"
        )
    mels, masks, accdoas = [], [], []
    for idx, (apath, mpath) in enumerate(zip(audio_files, metadata_files)):
        wave, sr = load_wav(apath)
        mel = compute_mel_features(wave, feat, device).cpu().numpy()  # (T_mel, C, F)
        t_lab = total_label_frames(wave.shape[1], sr, targets.label_frame_ms)
        frames, classes, sources, az, el = load_metadata_csv(mpath)
        if train and targets.use_gaussian_augmentation:
            mask = rasterize_gaussian_labels(
                frames, classes, sources, az, el, t_lab, n_el=grid.n_el, n_az=grid.n_az,
                num_classes=grid.num_classes, fanout=targets.fanout,
                sigma_azimuth=targets.sigma_azimuth,
                sigma_elevation=targets.sigma_elevation,
                seed=targets.augmentation_seed, file_key=idx, return_dense=False,
            )
        else:
            mask = encode_events_to_bitmask(frames, classes, az, el, t_lab, n_el=grid.n_el,
                                            n_az=grid.n_az, fanout=targets.fanout)
        t_common = min(mel.shape[0], mask.shape[0])
        mels.append(mel[:t_common])
        masks.append(mask[:t_common])
        if targets.accdoa:
            rasterize = (rasterize_adpit_targets if targets.accdoa_tracks > 1
                         else rasterize_accdoa_targets)
            acc = rasterize(frames, classes, az, el, t_lab,
                            num_event_classes=grid.num_classes - 1, fanout=targets.fanout)
            accdoas.append(acc[:t_common])

    mel = np.concatenate(mels, axis=0)
    mask = np.concatenate(masks, axis=0)
    accdoa = np.concatenate(accdoas, axis=0) if targets.accdoa else None
    total = mel.shape[0]
    win = window.window_frames(feat)
    hop = window.hop_frames(feat)
    starts = np.arange(0, total, hop, dtype=np.int32)  # every start < total
    pad = int(starts[-1]) + win - total
    if pad > 0:
        mel = np.concatenate([mel, np.zeros((pad, *mel.shape[1:]), mel.dtype)], axis=0)
        mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]), mask.dtype)], axis=0)
        if accdoa is not None:
            accdoa = np.concatenate([accdoa, np.zeros((pad, *accdoa.shape[1:]), accdoa.dtype)],
                                    axis=0)
    logger.info("Corpus: %d files, %d frames, %d windows of %d frames (hop %d)",
                len(audio_files), total, len(starts), win, hop)
    return WindowedCorpus(mel=mel, label_mask=mask, starts=starts, window_frames=win,
                          total_frames=total, n_el=grid.n_el, n_az=grid.n_az,
                          num_classes=grid.num_classes, accdoa=accdoa)
