"""Point targets against Gaussian-region targets of one metadata CSV
(counterpart: seld_tpu/tools/augment_compare.py): how many more active
cells the Gaussian label augmentation makes, and a before / after PNG of
one frame (matplotlib). Numpy on the host; no device.

    from seld_tpu_torch.tools.augment_compare import compare_augmentation
    stats = compare_augmentation("clip.csv", total_frames=3000, save_dir="out")
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from seld_tpu_torch.config import Config
from seld_tpu_torch.targets.gaussian import rasterize_gaussian_labels
from seld_tpu_torch.targets.rasterize import encode_events_to_bitmask, load_metadata_csv


def compare_augmentation(
    metadata_path,
    total_frames: int,
    cfg: Config | None = None,
    save_dir=None,
    frame: int | None = None,
) -> dict:
    """Returns inflation statistics; with save_dir it also writes
    <save_dir>/augmentation_compare_frame{frame}.png (frame None: the
    frame with the most active point cells) and names it under "figure"."""
    cfg = cfg or Config()
    g, t = cfg.grid, cfg.targets
    frames, classes, sources, az, el = load_metadata_csv(metadata_path)

    point = encode_events_to_bitmask(
        frames, classes, az, el, total_frames, g.n_el, g.n_az, t.fanout
    )
    gauss = rasterize_gaussian_labels(
        frames, classes, sources, az, el, total_frames,
        n_el=g.n_el, n_az=g.n_az, num_classes=g.num_classes, fanout=t.fanout,
        sigma_azimuth=t.sigma_azimuth, sigma_elevation=t.sigma_elevation,
        seed=t.augmentation_seed, return_dense=False,
    )

    point_active = int((point != 0).sum())
    gauss_active = int((gauss != 0).sum())
    stats = {
        "total_frames": total_frames,
        "point_active_cells": point_active,
        "gaussian_active_cells": gauss_active,
        "inflation_ratio": gauss_active / max(point_active, 1),
        "frames_with_events": int(((point != 0).any(axis=1)).sum()),
    }

    if save_dir is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if frame is None:
            frame = int(np.argmax((point != 0).sum(axis=1)))
        fig, axes = plt.subplots(1, 2, figsize=(14, 4))
        for ax, mask, title in (
            (axes[0], point, "point targets"),
            (axes[1], gauss, "gaussian-region targets"),
        ):
            grid = (mask[frame] != 0).reshape(g.n_el, g.n_az)
            ax.imshow(
                grid, origin="lower", extent=[-180, 180, -90, 90],
                aspect="auto", cmap="Reds", vmin=0, vmax=1,
            )
            ax.set_title(f"{title} — frame {frame} "
                         f"({int(grid.sum())} active cells)")
            ax.set_xlabel("azimuth (deg)")
            ax.set_ylabel("elevation (deg)")
        fig.suptitle(
            f"Gaussian augmentation inflation: x{stats['inflation_ratio']:.2f}"
        )
        out = Path(save_dir) / f"augmentation_compare_frame{frame}.png"
        out.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        stats["figure"] = str(out)

    return stats
