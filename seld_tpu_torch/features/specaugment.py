"""SpecAugment: time and frequency masking of a feature batch inside the
train step (counterpart: seld_tpu/features/specaugment.py).

Per sample and per mask (Park et al. 2019): width w uniform in {0..W},
start uniform in {0..size - w}. Masked positions take the sample's
per-channel mean over (time, frequency): zeros would be loud silence in
log-mel planes, and a global mean would push log-mel values into the
intensity-vector or GCC planes. Masks span all channels. The masks come
from an explicit torch.Generator; `apply_spec_augment` takes given masks.
"""

from __future__ import annotations

import torch


def axis_mask(generator: torch.Generator, batch: int, n_masks: int, max_width: int,
              size: int) -> torch.Tensor:
    """(batch, size) bool, True where a position is masked: n_masks
    intervals per row, widths uniform in {0..max_width}, starts uniform in
    {0..size - width}, drawn from `generator` on its device."""
    device = generator.device
    widths = torch.randint(0, max_width + 1, (batch, n_masks, 1), generator=generator,
                           device=device)
    room = size - widths + 1
    u = torch.rand((batch, n_masks, 1), generator=generator, device=device)
    starts = torch.minimum((u * room).long(), room - 1)  # rounding never overshoots
    pos = torch.arange(size, device=device)
    return ((pos >= starts) & (pos < starts + widths)).any(dim=1)


def apply_spec_augment(mel: torch.Tensor, time_mask: torch.Tensor | None,
                       freq_mask: torch.Tensor | None) -> torch.Tensor:
    """mel (B, T, C, F); time_mask (B, T) and freq_mask (B, F) bool or
    None -> mel with every masked frame and bin set to the sample's
    per-channel mean."""
    fill = mel.mean(dim=(1, 3), keepdim=True)
    masked = torch.zeros((), dtype=torch.bool, device=mel.device)
    if time_mask is not None:
        masked = masked | time_mask[:, :, None, None]
    if freq_mask is not None:
        masked = masked | freq_mask[:, None, None, :]
    return torch.where(masked, fill, mel)


def spec_augment(generator: torch.Generator, mel: torch.Tensor, time_masks: int,
                 time_width: int, freq_masks: int, freq_width: int) -> torch.Tensor:
    """SpecAugment with masks drawn from `generator`; the input itself
    when both mask counts are zero."""
    if time_masks <= 0 and freq_masks <= 0:
        return mel
    b, t, _, f = mel.shape
    tm = axis_mask(generator, b, time_masks, min(time_width, t), t) if time_masks > 0 else None
    fm = axis_mask(generator, b, freq_masks, min(freq_width, f), f) if freq_masks > 0 else None
    return apply_spec_augment(mel, tm, fm)


def make_spec_augment(train_cfg):
    """The train step's hook augment(generator, mel) -> mel from a
    TrainConfig, or None when both mask counts are zero."""
    if train_cfg.specaugment_time_masks <= 0 and train_cfg.specaugment_freq_masks <= 0:
        return None

    def augment(generator: torch.Generator, mel: torch.Tensor) -> torch.Tensor:
        return spec_augment(generator, mel, train_cfg.specaugment_time_masks,
                            train_cfg.specaugment_time_width,
                            train_cfg.specaugment_freq_masks,
                            train_cfg.specaugment_freq_width)

    return augment
