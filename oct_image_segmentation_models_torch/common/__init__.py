"""Host-side helpers of the port: checkpoint I/O and the weights bridge,
datasets, metrics and plots, and the evaluation metric names below (those
of the JAX package's ``common/__init__.py``)."""

EVALUATION_METRIC_DICE_CLASSES = "dice_coef_classes"
EVALUATION_METRIC_DICE_MACRO = "dice_coef_macro"
EVALUATION_METRIC_DICE_MICRO = "dice_coef_micro"
EVALUATION_METRIC_AVERAGE_SURFACE_DISTANCE = "average_surface_distance"
EVALUATION_METRIC_HAUSDORFF_DISTANCE = "hausdorff_distance"

EVALUATION_METRICS = {
    EVALUATION_METRIC_DICE_CLASSES,
    EVALUATION_METRIC_DICE_MACRO,
    EVALUATION_METRIC_DICE_MICRO,
    EVALUATION_METRIC_AVERAGE_SURFACE_DISTANCE,
    EVALUATION_METRIC_HAUSDORFF_DISTANCE,
}
