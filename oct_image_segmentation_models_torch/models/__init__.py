"""Model registry, counterpart of the JAX package's ``models/__init__.py``
(TransUNet is the port's alone)."""

from typing import Type

from .base_model import BaseModel
from .deeplabv3plus import DEEPLABV3PLUS_MODEL_NAME, DeeplabV3Plus
from .transunet import TRANSUNET_MODEL_NAME, TransUNet
from .unet import UNET_MODEL_NAME, UNet

model_name_map = {
    UNET_MODEL_NAME: UNet,
    DEEPLABV3PLUS_MODEL_NAME: DeeplabV3Plus,
    TRANSUNET_MODEL_NAME: TransUNet,
}


def get_model_class(model_name: str) -> Type[BaseModel]:
    model_class = model_name_map.get(model_name)
    if model_class is None:
        raise ValueError(f"Model name: '{model_name}' could not be found.")
    return model_class
