"""Model-container contract, counterpart of the JAX package's
``models/base_model.py``.

A container holds the architecture's hyper-parameters and knows how to
build the compute module (a PyTorch ``nn.Module``), expose its config
dict and give the input-preprocessing function.
"""

from __future__ import annotations

import abc
from typing import Callable

from torch import nn


class BaseModel(abc.ABC):
    def __init__(
        self,
        *,
        input_channels: int,
        num_classes: int,
        image_height: int,
        image_width: int,
    ):
        self.input_channels = input_channels
        self.num_classes = num_classes
        self.image_height = image_height
        self.image_width = image_width

    @abc.abstractmethod
    def build_model(self, generator=None, device=None) -> nn.Module:
        """Return the module implementing the architecture, initialised
        from ``generator`` and placed on ``device``."""

    def get_config(self) -> dict:
        return {
            "input_channels": self.input_channels,
            "num_classes": self.num_classes,
            "image_height": self.image_height,
            "image_width": self.image_width,
        }

    @abc.abstractmethod
    def get_preprocess_input_fn(self) -> Callable:
        """Return the input preprocessing function (tensor in, tensor out)."""

    @property
    def spatial_divisor(self) -> int:
        """Input H/W must be multiples of this for the forward to run."""
        return 1

    def apply_pretrained_weights(self, state_dict: dict) -> dict:
        """Hook: a freshly initialised ``state_dict`` with pretrained
        weights put in, for the surfaces that build a model from scratch
        (``train_model``). A no-op here; DeepLabV3+ loads its Keras
        ResNet50 backbone."""
        return state_dict
