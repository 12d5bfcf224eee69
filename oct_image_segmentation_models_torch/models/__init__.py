"""Model registry, counterpart of the JAX package's ``models/__init__.py``."""

from typing import Type

from .base_model import BaseModel
from .deeplabv3plus import DEEPLABV3PLUS_MODEL_NAME, DeeplabV3Plus
from .unet import UNET_MODEL_NAME, UNet

model_name_map = {
    UNET_MODEL_NAME: UNet,
    DEEPLABV3PLUS_MODEL_NAME: DeeplabV3Plus,
}


def get_model_class(model_name: str) -> Type[BaseModel]:
    model_class = model_name_map.get(model_name)
    if model_class is None:
        raise ValueError(f"Model name: '{model_name}' could not be found.")
    return model_class
