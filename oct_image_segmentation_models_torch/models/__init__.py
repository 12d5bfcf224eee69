"""Model registry, counterpart of the JAX package's ``models/__init__.py``."""

from typing import Type

from .base_model import BaseModel
from .unet import UNET_MODEL_NAME, UNet

DEEPLABV3PLUS_MODEL_NAME = "deeplabv3plus"

model_name_map = {
    UNET_MODEL_NAME: UNet,
}


def get_model_class(model_name: str) -> Type[BaseModel]:
    if model_name == DEEPLABV3PLUS_MODEL_NAME:
        raise NotImplementedError(
            "DeepLabV3+ is not ported to PyTorch yet (ROADMAP A11)"
        )
    model_class = model_name_map.get(model_name)
    if model_class is None:
        raise ValueError(f"Model name: '{model_name}' could not be found.")
    return model_class
