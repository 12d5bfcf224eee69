"""Plot artifacts (training curves, segmentation maps, boundary overlays),
counterpart of the JAX package's ``common/plotting.py``, with the same
colour tables.

matplotlib is imported inside the functions that draw, with the Agg
backend, so that the port imports on a machine without it. There the
plots the workflows always draw (the raw image and boundary overlays of
predict and evaluate, the training curves) are left out, with one warning
(:func:`available`); the plots asked for with ``png_images`` need it.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

predict_colours = [
    "#4285f4", "#db4437", "#f4b400", "#0f9d58", "#ff6d00", "#46bdc6",
    "#ab30c4", "#fde8ff", "#4285f4", "#db4437", "#f4b400", "#0f9d58",
]
truth_colours = [
    "#2b5790", "#7a261e", "#9b7200", "#085630", "#8e3d00", "#26686d",
    "#5f1a6d", "#f266ff", "#2b5790", "#7a261e", "#9b7200", "#085630",
]
region_colours = [
    "#fde8ff", "#4285f4", "#db4437", "#f4b400", "#0f9d58", "#ff6d00",
    "#46bdc6", "#ab30c4", "#0e0d5e", "#fde8ff", "#4285f4", "#db4437",
]


_warned_missing = False


def available() -> bool:
    """Whether matplotlib imports; when it does not, one warning per
    process says that the plots are left out."""
    global _warned_missing
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        if not _warned_missing:
            log.warning("matplotlib is not installed: the PNG plots are not written")
            _warned_missing = True
        return False
    return True


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot

    return pyplot


def region_cmap(n=None):
    """The region colour table as a colormap of ``n`` colours (all of
    them when None)."""
    from matplotlib import colors

    return colors.ListedColormap(region_colours, N=n)


def save_cur_trainval_plot(
    acc_name,
    loss_name,
    network_name,
    num_epochs,
    epoch,
    train_accs,
    val_accs,
    train_losses,
    val_losses,
    filename,
):
    """Two-pane train/val curve plot. NaN epochs (before a resume, or a
    diverged run) are skipped; a metric with no finite value reads
    "n/a". Without matplotlib nothing is drawn (:func:`available`)."""
    if not available():  # a missing curve plot must not stop training
        return
    plt = _pyplot()
    f, (ax1, ax2) = plt.subplots(2, 1, sharex=False, sharey=False)
    f.set_size_inches(15, 15)
    for ax, ylabel in ((ax1, acc_name), (ax2, loss_name)):
        ax.grid()
        ax.spines["right"].set_visible(False)
        ax.spines["top"].set_visible(False)
        ax.yaxis.set_ticks_position("left")
        ax.xaxis.set_ticks_position("bottom")
        ax.set(ylabel=ylabel, xlim=(1, max(num_epochs, 2)))
    plt.xlabel("Epoch")

    train_accs = np.asarray(train_accs, dtype=float)
    val_accs = np.asarray(val_accs, dtype=float)
    train_losses = np.asarray(train_losses, dtype=float)
    val_losses = np.asarray(val_losses, dtype=float)

    def _best(values, reducer, arg_reducer):
        if np.all(np.isnan(values)):
            return float("nan"), None
        return reducer(values), arg_reducer(values)

    def _fmt(value, ep, scale=1.0, digits=2):
        if ep is None:
            return "n/a (no finite values)"
        return f"{value * scale:.{digits}f} at epoch {ep + 1:d}"

    best_tr_acc, best_tr_acc_ep = _best(train_accs, np.nanmax, np.nanargmax)
    best_va_acc, best_va_acc_ep = _best(val_accs, np.nanmax, np.nanargmax)
    best_tr_loss, best_tr_loss_ep = _best(train_losses, np.nanmin, np.nanargmin)
    best_va_loss, best_va_loss_ep = _best(val_losses, np.nanmin, np.nanargmin)
    f.suptitle(
        f"Network: {network_name}\n\n"
        f"Best training {acc_name}: "
        f"{_fmt(best_tr_acc, best_tr_acc_ep, scale=100.0)} | "
        f"Best validation {acc_name}: "
        f"{_fmt(best_va_acc, best_va_acc_ep, scale=100.0)}\n\n"
        f"Best training {loss_name}: "
        f"{_fmt(best_tr_loss, best_tr_loss_ep, digits=4)} | "
        f"Best validation {loss_name}: "
        f"{_fmt(best_va_loss, best_va_loss_ep, digits=4)}",
        fontsize=14,
        fontweight="bold",
    )

    epochs_axis = list(range(1, epoch + 2))
    for ax, (tr, va) in ((ax1, (train_accs, val_accs)), (ax2, (train_losses, val_losses))):
        ax.plot(epochs_axis, tr[: epoch + 1], color="#4286f4")
        ax.plot(epochs_axis, va[: epoch + 1], color="#b20e0e")
        ax.plot(epochs_axis, tr[: epoch + 1], ".", color="#4286f4")
        ax.plot(epochs_axis, va[: epoch + 1], ".", color="#b20e0e")
    ax1.legend(["Train Acc", "Val Acc"])
    ax2.legend(["Train Loss", "Val Loss"])

    try:
        plt.savefig(filename)
    except Exception:  # a failed curve plot must not stop training
        log.warning("could not save the curve plot %s", filename, exc_info=True)
    plt.close()


def setup_image_plot(image, cmap, vmin=None, vmax=None):
    """A figure of the image's size in pixels at 100 dpi, without axes."""
    plt = _pyplot()
    image = np.asarray(image)
    if image.ndim == 3:
        image_height, image_width = image.shape[:-1]
        if image.shape[2] == 1:
            image = image[:, :, 0]
    else:
        image_height, image_width = image.shape

    fig = plt.figure(num=None, figsize=(image_width / 100, image_height / 100), dpi=100)
    ax = plt.Axes(fig, [0.0, 0.0, 1.0, 1.0])
    ax.set_axis_off()
    fig.add_axes(ax)
    if cmap is None:
        plt.imshow(image, vmin=vmin, vmax=vmax)
    else:
        plt.imshow(image, cmap=cmap, vmin=vmin, vmax=vmax)
    return plt


def save_image_plot(image, filename: Path, cmap, vmin=None, vmax=None):
    plt = setup_image_plot(image, cmap, vmin, vmax)
    plt.savefig(filename)
    plt.close()


def save_image_plot_crop(image, filename, cmap, crop_bounds, vmin=None, vmax=None):
    image = np.array(
        image[
            crop_bounds[0][0] : crop_bounds[0][1],
            crop_bounds[1][0] : crop_bounds[1][1],
        ]
    )
    save_image_plot(image, filename, cmap, vmin, vmax)


def save_segmentation_plot(
    image,
    image_cmap,
    filename,
    truths,
    predictions,
    column_range=None,
    linewidth=4.0,
    color=None,
):
    """Boundary overlay: truths solid, predictions dotted, row 0 masked to
    NaN."""
    plt = setup_image_plot(image, image_cmap, vmin=0, vmax=255)

    ref = truths if truths is not None else predictions
    num_boundaries = ref.shape[0]
    if column_range is None:
        column_range = range(0, ref.shape[1])
    cols = slice(column_range[0], column_range[-1] + 1)

    if truths is not None:
        truths = truths.astype("float64")
        truths[truths == 0] = np.nan
        for b in range(num_boundaries):
            plt.plot(
                column_range,
                truths[b, cols],
                linewidth=linewidth,
                color=color or truth_colours[b],
            )
    if predictions is not None:
        predictions = predictions.astype("float64")
        predictions[predictions == 0] = np.nan
        for b in range(num_boundaries):
            plt.plot(
                column_range,
                predictions[b, cols],
                linestyle=":",
                linewidth=linewidth,
                color=color or predict_colours[b],
            )

    plt.savefig(filename)
    plt.close()
