"""Evaluation workflow."""

from .evaluation import EvaluationOutput, evaluate_model  # noqa: F401
from .evaluation_parameters import (  # noqa: F401
    EvaluationParameters,
    EvaluationSaveParams,
)
