"""Training losses in PyTorch, counterpart of the JAX package's
``ops/losses.py`` (the reference's ``common/custom_losses.py``).

Every factory keeps the JAX registry entry's keyword surface
(``num_classes`` / ``is_y_true_sparse`` / loss-specific kwargs) and returns
``fn(y_true, y_pred) -> 0-d tensor``, differentiable in ``y_pred``.

Conventions:
- ``y_pred``: ``(B, ..., C)`` softmax probabilities, channels last;
- ``y_true``: one-hot ``(B, ..., C)`` when the loss registers
  ``takes_sparse=False``, else integer labels ``(B, ..., 1)`` or ``(B, ...)``;
- the scalar is the mean over all elements.

Clipping goes through :func:`_clip` (``torch.minimum`` of ``torch.maximum``)
and not ``torch.clamp``: at an input equal to a bound ``jnp.clip`` passes
half the gradient and ``torch.clamp`` all of it, and saturated softmax
outputs (p == 1.0 exactly) do occur in training.

A loss call copies nothing from the host to the card, so the train step
never waits for the host: constants are filled on the device and a class
weight is copied to a device once, by :class:`PerDevice`.

The JAX package's documented repairs of the reference are kept:
``bce_focal_loss`` is mean(BCE) + mean(focal, gamma=2) on the argmax
labels, and ``bce_logdice_loss`` / ``weighted_bce_dice_loss`` call the
micro-Dice loss itself where the reference called its factory.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import PerDevice
from .boundary import to_categorical

_EPS_KERAS = 1e-7  # keras.backend.epsilon()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient: half at a bound."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _squeeze_labels(y_true: torch.Tensor) -> torch.Tensor:
    """Drop a trailing singleton channel axis."""
    if y_true.ndim and y_true.shape[-1] == 1:
        return y_true[..., 0]
    return y_true


def _maybe_one_hot(y_true, num_classes, is_sparse):
    if is_sparse:
        return to_categorical(_squeeze_labels(y_true), num_classes)
    return y_true


def dice_loss_micro(*, is_y_true_sparse: bool, num_classes: int, **kwargs):
    """Global (micro) soft-Dice loss."""

    def _dice_loss_micro(y_true, y_pred, smooth=1e-05):
        y_true = _maybe_one_hot(y_true, num_classes, is_y_true_sparse)
        t = y_true.reshape(-1).to(torch.float32)
        p = y_pred.reshape(-1).to(torch.float32)
        intersection = torch.sum(t * p)
        score = (2.0 * intersection + smooth) / (torch.sum(t) + torch.sum(p) + smooth)
        return 1.0 - score

    return _dice_loss_micro


def dice_loss_macro(*, is_y_true_sparse: bool, num_classes: int, **kwargs):
    """Per-class (macro) soft-Dice loss, averaged over (batch, class)."""

    def _dice_loss_macro(y_true, y_pred, smooth=1e-05):
        y_true = _maybe_one_hot(y_true, num_classes, is_y_true_sparse)
        reduce_axes = tuple(range(1, y_pred.ndim - 1))
        y_true = y_true.to(torch.float32)
        y_pred = y_pred.to(torch.float32)
        intersection = torch.sum(y_true * y_pred, dim=reduce_axes)
        denom = torch.sum(y_true, dim=reduce_axes) + torch.sum(y_pred, dim=reduce_axes)
        score = (2.0 * intersection + smooth) / (denom + smooth)
        return 1.0 - torch.mean(score)

    return _dice_loss_macro


def _binary_crossentropy(y_true, y_pred):
    """Keras ``binary_crossentropy``: per-element BCE with probability
    clipping, averaged over the channel axis."""
    p = _clip(y_pred.to(torch.float32), _EPS_KERAS, 1.0 - _EPS_KERAS)
    t = y_true.to(torch.float32)
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    return torch.mean(bce, dim=-1)


def bce_dice_loss(*, num_classes: int, **kwargs):
    """Binary cross-entropy + micro Dice."""
    dice_fn = dice_loss_micro(is_y_true_sparse=False, num_classes=num_classes)

    def _bce_dice_loss(y_true, y_pred):
        return torch.mean(_binary_crossentropy(y_true, y_pred)) + dice_fn(y_true, y_pred)

    return _bce_dice_loss


def _sparse_focal_map(y_true, y_pred, gamma, class_weight):
    """Per-pixel sparse categorical focal loss
    ``-w[y] * (1 - p_y)^gamma * log(p_y)``, ``class_weight`` a
    :class:`PerDevice` or None. An out-of-range label gives an all-zero
    one-hot row, so ``p_y`` sits at the clip floor (or the pixel drops out
    with ``class_weight``), as in JAX."""
    labels = _squeeze_labels(y_true).to(torch.int64)
    p = _clip(y_pred.to(torch.float32), _EPS_KERAS, 1.0)
    classes = torch.arange(p.shape[-1], device=p.device)
    oh = (labels[..., None] == classes).to(torch.float32)
    p_y = _clip(torch.sum(p * oh, dim=-1), _EPS_KERAS, 1.0)
    focal = -((1.0 - p_y) ** gamma) * torch.log(p_y)
    if class_weight is not None:
        if len(class_weight) < p.shape[-1]:
            raise ValueError(
                f"class_weight has {len(class_weight)} entries but predictions "
                f"have {p.shape[-1]} channels; provide one weight per class"
            )
        w = class_weight.on(p.device)
        focal = focal * torch.sum(oh * w[: p.shape[-1]], dim=-1)
    return focal


def focal_loss(gamma: float = 2, class_weight: Optional[np.ndarray] = None, **kwargs):
    """Sparse categorical focal loss."""
    class_weight = None if class_weight is None else PerDevice(class_weight)

    def _focal_loss(y_true, y_pred):
        return torch.mean(_sparse_focal_map(y_true, y_pred, gamma, class_weight))

    return _focal_loss


def focal_dice_loss(
    *,
    num_classes: int,
    gamma: float = 2,
    class_weight: Optional[np.ndarray] = None,
    focal_loss_weight: float = 0.5,
    dice_macro: bool = True,
    **kwargs,
):
    """``w * focal + (1 - w) * dice``; the Dice term takes the sparse
    labels."""
    dice_factory = dice_loss_macro if dice_macro else dice_loss_micro
    dice_fn = dice_factory(is_y_true_sparse=True, num_classes=num_classes)
    class_weight = None if class_weight is None else PerDevice(class_weight)

    def _focal_dice_loss(y_true, y_pred):
        focal = torch.mean(_sparse_focal_map(y_true, y_pred, gamma, class_weight))
        dice = dice_fn(y_true, y_pred)
        return focal_loss_weight * focal + (1.0 - focal_loss_weight) * dice

    return _focal_dice_loss


def bce_focal_loss(*, num_classes: int, gamma: float = 2, **kwargs):
    """BCE + focal, the focal term on the one-hot labels' argmax (the JAX
    package's repair of the reference)."""

    def _bce_focal_loss(y_true, y_pred):
        sparse = torch.argmax(y_true, dim=-1)
        bce = torch.mean(_binary_crossentropy(y_true, y_pred))
        focal = torch.mean(_sparse_focal_map(sparse, y_pred, gamma, None))
        return bce + focal

    return _bce_focal_loss


def weighted_categorical_crossentropy(weights):
    """Class-weighted categorical cross-entropy (off-registry).
    Predictions are renormalised across the channel axis and clipped with
    the Keras epsilon before the log."""
    weights = PerDevice(weights)

    def loss(y_true, y_pred):
        w = weights.on(y_pred.device)
        p = y_pred.to(torch.float32)
        p = p / torch.sum(p, dim=-1, keepdim=True)
        p = _clip(p, _EPS_KERAS, 1.0 - _EPS_KERAS)
        ce = -torch.sum(y_true.to(torch.float32) * torch.log(p) * w, dim=-1)
        return torch.mean(ce)

    return loss


def bce_logdice_loss(y_true, y_pred):
    """BCE - log(1 - micro-Dice loss) on dense one-hot labels."""
    dice = dice_loss_micro(is_y_true_sparse=False, num_classes=None)
    bce = torch.mean(_binary_crossentropy(y_true, y_pred))
    return bce - torch.log(1.0 - dice(y_true, y_pred))


def weighted_bce_loss(y_true, y_pred, weight):
    """Per-element-weighted BCE in the stable logit form, normalised by the
    weight mass."""
    t = y_true.to(torch.float32)
    p = _clip(y_pred.to(torch.float32), _EPS_KERAS, 1.0 - _EPS_KERAS)
    logit = torch.log(p / (1.0 - p))
    loss = weight * (
        logit * (1.0 - t)
        + torch.log1p(torch.exp(-torch.abs(logit)))
        + torch.maximum(-logit, torch.zeros((), device=logit.device))
    )
    return torch.sum(loss) / torch.sum(weight)


def weighted_dice_loss(y_true, y_pred, weight):
    """Weight-mass soft Dice."""
    m1 = y_true.to(torch.float32)
    m2 = y_pred.to(torch.float32)
    smooth = 1.0
    score = (2.0 * torch.sum(weight * m1 * m2) + smooth) / (
        torch.sum(weight * m1) + torch.sum(weight * m2) + smooth
    )
    return 1.0 - score


def _same_avg_pool_hw(x, size):
    """Average pool over the spatial axes of ``(B, H, W, C)``, stride 1,
    "SAME" padding, averaging only the valid window elements (TF's AVG
    pool). The pad before/after is ``(size - 1) // 2`` / the rest, as
    XLA's "SAME"."""
    before = (size - 1) // 2
    pads = (before, size - 1 - before, before, size - 1 - before)
    x = x.to(torch.float32).permute(0, 3, 1, 2)
    sums = F.avg_pool2d(F.pad(x, pads), size, stride=1, divisor_override=1)
    ones = F.pad(torch.ones_like(x[:1, :1]), pads)
    counts = F.avg_pool2d(ones, size, stride=1, divisor_override=1)
    return (sums / counts).permute(0, 2, 3, 1)


def weighted_bce_dice_loss(y_true, y_pred):
    """Border-emphasising weighted BCE + micro Dice: weights peak (x5,
    renormalised to unit mean) where a 50x50 local average of the mask is
    near 0.5."""
    t = y_true.to(torch.float32)
    p = y_pred.to(torch.float32)
    averaged_mask = _same_avg_pool_hw(t, 50)
    weight = 5.0 * torch.exp(-5.0 * torch.abs(averaged_mask - 0.5))
    w0 = averaged_mask.new_full((), float(averaged_mask.numel()))
    weight = weight * (w0 / torch.sum(weight))
    dice = dice_loss_micro(is_y_true_sparse=False, num_classes=None)
    return weighted_bce_loss(t, p, weight) + dice(t, p)


def compute_balanced_class_weight(labels: np.ndarray) -> np.ndarray:
    """sklearn ``class_weight='balanced'``: n / (num_classes * bincount)."""
    labels = np.asarray(labels).ravel().astype(np.int64)
    classes, counts = np.unique(labels, return_counts=True)
    weights = labels.size / (len(classes) * counts.astype(np.float64))
    out = np.zeros(int(classes.max()) + 1, dtype=np.float64)
    out[classes] = weights
    return out


custom_loss_objects = {
    "bce_dice_loss": {"function": bce_dice_loss, "takes_sparse": False},
    "dice_loss_micro": {"function": dice_loss_micro, "takes_sparse": False},
    "dice_loss_macro": {"function": dice_loss_macro, "takes_sparse": False},
    "focal_loss": {"function": focal_loss, "takes_sparse": True},
    "bce_focal_loss": {"function": bce_focal_loss, "takes_sparse": False},
    "focal_dice_loss": {"function": focal_dice_loss, "takes_sparse": True},
}
