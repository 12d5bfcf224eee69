"""Prediction workflow and volume-streaming inference."""

from .prediction import PredictionOutput, predict  # noqa: F401
from .prediction_parameters import (  # noqa: F401
    PredictionParams,
    PredictionSaveParams,
)
