"""PNG artifacts: loss curves, grid predictions, loss components
(counterpart: seld_tpu/viz.py; the same names, signatures, panels, titles,
texts, file names and dpi, drawn with matplotlib's Agg backend).

  * plot_loss_curves: train and test loss per epoch, the best epoch of
    each marked;
  * visualize_grid_predictions: ground truth, prediction and agreement
    class maps of one frame, with the frame's cell accuracy;
  * visualize_loss_components: a 12-panel dashboard of the loss internals
    (GT and predicted activity, classes and event masks, the AIUR
    intersection and union, the CL attention map and its contribution);
    draw_loss_components draws it from the one frame it shows, so a caller
    whose logits lie on a device copies just that frame to the host.

Every grid input is class-major (..., M, G) numpy. The dashboard's softmax
over the class axis is float32 numpy. The package imports this module, and
with it matplotlib, only where a PNG is drawn.
"""

from __future__ import annotations

from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def _save_or_return(fig, save_path):
    if save_path is not None:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_loss_curves(train_losses, test_losses, save_path=None):
    epochs = np.arange(1, len(train_losses) + 1)
    fig, ax = plt.subplots(figsize=(9, 5))
    ax.plot(epochs, train_losses, label="train", lw=1.8)
    ax.plot(epochs, test_losses, label="test", lw=1.8)
    if len(train_losses):
        bt = int(np.argmin(train_losses))
        bv = int(np.argmin(test_losses))
        ax.scatter([bt + 1], [train_losses[bt]], marker="*", s=140, zorder=5)
        ax.scatter([bv + 1], [test_losses[bv]], marker="*", s=140, zorder=5)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title("Training / test loss")
    ax.legend()
    ax.grid(alpha=0.3)
    return _save_or_return(fig, save_path)


def _class_grid(labels_or_logits, n_el, n_az):
    """Class-major (M, G) -> (I, J) argmax class map."""
    g = labels_or_logits.reshape(-1, n_el, n_az)
    return np.argmax(g, axis=0)


def visualize_grid_predictions(
    ground_truth,
    predictions,
    time_frame: int = 0,
    grid_size=(18, 36),
    num_classes: int = 14,
    title_prefix: str = "",
    save_path=None,
):
    """3-panel GT / prediction / agreement plot for one frame's
    class-major (M, G) labels/logits."""
    n_el, n_az = grid_size
    gt = _class_grid(np.asarray(ground_truth), n_el, n_az)
    pred = _class_grid(np.asarray(predictions), n_el, n_az)
    bg = num_classes - 1

    fig, axes = plt.subplots(1, 3, figsize=(18, 4.5))
    for ax, data, title in [
        (axes[0], gt, "ground truth"),
        (axes[1], pred, "prediction"),
    ]:
        im = ax.imshow(
            np.ma.masked_equal(data, bg), origin="lower",
            extent=[-180, 180, -90, 90], aspect="auto",
            cmap="tab20", vmin=0, vmax=num_classes - 1,
        )
        ax.set_title(f"{title_prefix}{title} (frame {time_frame})")
        ax.set_xlabel("azimuth (deg)")
        ax.set_ylabel("elevation (deg)")
        fig.colorbar(im, ax=ax, shrink=0.8)

    agree = (gt == pred).astype(float)
    axes[2].imshow(
        agree, origin="lower", extent=[-180, 180, -90, 90], aspect="auto",
        cmap="RdYlGn", vmin=0, vmax=1,
    )
    acc = float(agree.mean()) * 100
    nb = gt != bg
    nb_acc = float((gt[nb] == pred[nb]).mean()) * 100 if nb.any() else float("nan")
    axes[2].set_title(f"agreement — acc {acc:.1f}% / non-bg {nb_acc:.1f}%")
    axes[2].set_xlabel("azimuth (deg)")
    fig.tight_layout()
    return _save_or_return(fig, save_path)


def visualize_loss_components(
    logits,
    labels,
    n_el: int = 18,
    n_az: int = 36,
    frame_idx: int | None = None,
    epoch=None,
    save_dir=None,
):
    """12-panel loss-internals dashboard of one frame of class-major
    (B, T, M, G) logits and labels (see draw_loss_components).
    `frame_idx=None` picks the (batch, time) frame with the most
    non-background GT cells; an int pins (batch 0, frame_idx)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    m = labels.shape[2]
    if frame_idx is None:
        counts = (np.argmax(labels, 2) != m - 1).sum(-1)  # (B, T)
        b, t = np.unravel_index(int(np.argmax(counts)), counts.shape)
    else:
        b, t = 0, frame_idx
    return draw_loss_components(logits[b, t], labels[b, t], b, t, n_el=n_el, n_az=n_az,
                                epoch=epoch, save_dir=save_dir)


def draw_loss_components(logits, labels, b: int, t: int, n_el: int = 18, n_az: int = 36,
                         epoch=None, save_dir=None):
    """The dashboard of frame (b, t), from its class-major (M, G) logits and
    labels:

      row 1 — GT activity, GT classes, GT event mask, GT statistics
      row 2 — pred activity, pred classes, pred event mask, pred statistics
      row 3 — AIUR intersection, AIUR union, CL attention map y_at,
              CL contribution (pred_nonbg * y_at)

    and the AIUR loss (with IoU, intersection and union counts) and the CL
    loss in the suptitle. With save_dir the figure goes to
    <save_dir>/loss_components_epoch{epoch}_f{t}.png."""
    labels = np.asarray(labels)
    m = labels.shape[0]
    x = np.asarray(logits, np.float32)
    e = np.exp(x - x.max(axis=0, keepdims=True))
    probs = e / e.sum(axis=0, keepdims=True)

    true = labels.reshape(m, n_el, n_az)
    pred = probs.reshape(m, n_el, n_az)
    true_act = true[:-1].sum(0)
    pred_act = pred[:-1].sum(0)
    true_cls = np.argmax(true, 0)
    pred_cls = np.argmax(pred, 0)
    true_mask = (true_cls != m - 1).astype(float)
    pred_mask = (pred_cls != m - 1).astype(float)
    inter = true_mask * pred_mask
    union = np.clip(true_mask + pred_mask, 0, 1)

    # CL internals (mirror of losses.converging_localization_loss)
    is_event = true_act > 0.01
    n_bac, n_non = float((~is_event).sum()), float(is_event.sum())
    y_prime = np.where(is_event, -(n_bac / (n_non + 1e-10)), 1.0)
    diff = np.zeros_like(y_prime)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di or dj:
                diff += np.roll(y_prime, (-di, -dj), axis=(0, 1)) - y_prime
    y_at = y_prime + diff / 8.0
    cl_contrib = pred_act * y_at

    iou = inter.sum() / max(union.sum(), 1e-8) if union.sum() > 0 else 1.0
    aiur_val = 1.0 - iou
    cl_val = cl_contrib.sum() / (n_non * n_el * n_az + 1e-8) if n_non > 0 else 0.0

    fig, axes = plt.subplots(3, 4, figsize=(22, 12))

    def show(ax, data, title, cmap="YlOrRd", **imkw):
        im = ax.imshow(data, origin="lower", aspect="auto", cmap=cmap, **imkw)
        ax.set_title(title, fontsize=11)
        ax.set_xlabel("azimuth bins")
        ax.set_ylabel("elevation bins")
        fig.colorbar(im, ax=ax, shrink=0.8)

    clskw = dict(cmap="tab20", vmin=0, vmax=m - 1)
    show(axes[0, 0], true_act, "GT activity (non-bg sum)")
    show(axes[0, 1], true_cls, f"GT classes ({int(true_mask.sum())} active)", **clskw)
    show(axes[0, 2], true_mask, "GT event mask", cmap="Greys", vmin=0, vmax=1)
    axes[0, 3].axis("off")
    axes[0, 3].text(
        0.05, 0.5,
        f"Ground truth stats\n\n"
        f"total cells:      {n_el * n_az}\n"
        f"active cells:     {int(true_mask.sum())}\n"
        f"background cells: {int((1 - true_mask).sum())}\n"
        f"activity range:   [{true_act.min():.3f}, {true_act.max():.3f}]\n"
        f"N_bac: {n_bac:.0f}\nN_non: {n_non:.0f}",
        fontsize=10, va="center", family="monospace",
    )

    show(axes[1, 0], pred_act, "pred activity (non-bg sum)")
    show(axes[1, 1], pred_cls, f"pred classes ({int(pred_mask.sum())} active)", **clskw)
    show(axes[1, 2], pred_mask, "pred event mask", cmap="Greys", vmin=0, vmax=1)
    axes[1, 3].axis("off")
    axes[1, 3].text(
        0.05, 0.5,
        f"Prediction stats\n\n"
        f"total cells:      {n_el * n_az}\n"
        f"active cells:     {int(pred_mask.sum())}\n"
        f"background cells: {int((1 - pred_mask).sum())}\n"
        f"activity range:   [{pred_act.min():.3f}, {pred_act.max():.3f}]\n"
        f"confidence:       {pred.max(0).mean():.3f}",
        fontsize=10, va="center", family="monospace",
    )

    show(axes[2, 0], inter, "AIUR intersection", cmap="Greens", vmin=0, vmax=1)
    show(axes[2, 1], union, "AIUR union", cmap="Blues", vmin=0, vmax=1)
    show(axes[2, 2], y_at, "CL attention map y_at", cmap="RdBu_r")
    show(axes[2, 3], cl_contrib, "CL contribution (pred_nonbg * y_at)",
         cmap="RdBu_r")

    fig.suptitle(
        f"Loss components — epoch {epoch}, batch {b}, frame {t}\n"
        f"AIUR = {aiur_val:.4f} (IoU {iou:.4f}, I={int(inter.sum())}, "
        f"U={int(union.sum())}) | CL = {cl_val:.4f}",
        fontsize=13, fontweight="bold",
    )
    fig.tight_layout(rect=(0, 0, 1, 0.94))
    save_path = None
    if save_dir is not None:
        save_path = Path(save_dir) / f"loss_components_epoch{epoch}_f{t}.png"
    return _save_or_return(fig, save_path)
