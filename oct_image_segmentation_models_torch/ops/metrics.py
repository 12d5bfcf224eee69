"""Training-monitor and evaluation metrics in PyTorch, counterpart of the
JAX package's ``ops/metrics.py`` (the reference's
``common/custom_metrics.py`` formulas).

The two training monitors run inside the train and eval steps and return
0-d tensors on the input's device; surface distances live in
:mod:`..common.surface_distance`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import (
    TRAINING_MONITOR_METRIC_DICE_MACRO,
    TRAINING_MONITOR_METRIC_DICE_MICRO,
)
from .boundary import to_categorical


def _dense_labels(y_true, is_y_true_sparse, num_classes):
    if is_y_true_sparse:
        if y_true.shape[-1] == 1:
            y_true = y_true[..., 0]
        y_true = to_categorical(y_true, num_classes)
    return y_true


def dice_coef_micro(is_y_true_sparse: bool, num_classes: int):
    """Global Dice of the 0.5-thresholded prediction (no smoothing term: an
    empty union gives NaN, as in the reference)."""

    def _dice_coef_micro(y_true, y_pred):
        y_true = _dense_labels(y_true, is_y_true_sparse, num_classes)
        t = y_true.reshape(-1).to(torch.float32)
        p = (y_pred.reshape(-1).to(torch.float32) > 0.5).to(torch.float32)
        return 2.0 * torch.sum(t * p) / (torch.sum(t) + torch.sum(p))

    _dice_coef_micro.__name__ = "dice_coef_micro"
    return _dice_coef_micro


def dice_coef_macro(is_y_true_sparse: bool, num_classes: int):
    """Per-class Dice of the 0.5-thresholded prediction, averaged over
    (batch, class)."""

    def _dice_coef_macro(y_true, y_pred, eps=1e-05):
        y_true = _dense_labels(y_true, is_y_true_sparse, num_classes)
        p = (y_pred.to(torch.float32) > 0.5).to(torch.float32)
        t = y_true.to(torch.float32)
        reduce_axes = tuple(range(1, p.ndim - 1))
        intersection = torch.sum(t * p, dim=reduce_axes)
        denom = torch.sum(t, dim=reduce_axes) + torch.sum(p, dim=reduce_axes)
        score = (2.0 * intersection + eps) / (denom + eps)
        return torch.mean(score)

    _dice_coef_macro.__name__ = "dice_coef_macro"
    return _dice_coef_macro


training_monitor_metric_objects = {
    TRAINING_MONITOR_METRIC_DICE_MACRO: dice_coef_macro,
    TRAINING_MONITOR_METRIC_DICE_MICRO: dice_coef_micro,
}


def soft_dice_class(y_true, y_pred, eps=1e-5):
    """Per-(batch, class) soft Dice over class-first ``(B, C, ...)``
    tensors or arrays -> a float32 tensor."""
    y_true = torch.as_tensor(np.asarray(y_true) if not torch.is_tensor(y_true) else y_true)
    y_pred = torch.as_tensor(np.asarray(y_pred) if not torch.is_tensor(y_pred) else y_pred)
    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32)
    axes = tuple(range(2, y_pred.ndim))
    intersect = torch.sum(y_pred * y_true, dim=axes)
    denom = torch.sum(y_pred + y_true, dim=axes)
    return (2.0 * intersect + eps) / (denom + eps)
