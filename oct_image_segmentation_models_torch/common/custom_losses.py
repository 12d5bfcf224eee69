"""The reference's ``common/custom_losses.py`` import path; the losses
live in :mod:`..ops.losses`."""

from ..ops.losses import (  # noqa: F401
    bce_dice_loss,
    bce_focal_loss,
    bce_logdice_loss,
    compute_balanced_class_weight,
    custom_loss_objects,
    dice_loss_macro,
    dice_loss_micro,
    focal_dice_loss,
    focal_loss,
    weighted_bce_dice_loss,
    weighted_bce_loss,
    weighted_categorical_crossentropy,
    weighted_dice_loss,
)
