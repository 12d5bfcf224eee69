"""The reference's ``common/custom_metrics.py`` import path; the metrics
live in :mod:`..ops.metrics` and the surface distances in
:mod:`.surface_distance`."""

from ..ops.metrics import (  # noqa: F401
    dice_coef_macro,
    dice_coef_micro,
    soft_dice_class,
    training_monitor_metric_objects,
)
from .surface_distance import (  # noqa: F401
    average_surface_distance,
    hausdorff_distance,
)
