"""The training workflow: ``train_model`` and its parameters."""

from .training import train_model  # noqa: F401
from .training_parameters import TrainingParams  # noqa: F401
