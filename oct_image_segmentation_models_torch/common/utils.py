"""Host-side utilities, counterpart of the JAX package's
``common/utils.py``.

The array transforms run the port's :mod:`..ops.boundary` on the CPU;
these wrappers keep the numpy-facing call shapes and the JAX functions'
output dtypes.
"""

from __future__ import annotations

import datetime
import hashlib
import logging as log
from pathlib import Path

import numpy as np
import torch

from ..ops import boundary as boundary_ops


def get_timestamp() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d_%H_%M_%S")


def convert_maps_uint8(prob_maps):
    return (np.asarray(prob_maps) * 255).astype("uint8")


def perform_argmax(predictions, bin=True):
    """``(B, H, W, C)`` probabilities -> ``[argmax int32 (B, H, W),
    categorical float32 (B, C, H, W)]`` as numpy."""
    argmax_pred, categorical_pred = boundary_ops.perform_argmax(
        torch.as_tensor(np.asarray(predictions)), bin=bin
    )
    return [
        argmax_pred.to(torch.int32).numpy(),
        categorical_pred.contiguous().numpy(),
    ]


def convert_predictions_to_maps_semantic(categorical_pred, bg_ilm=True, bg_csi=False):
    """``(B, C, H, W)`` categorical -> ``(B, C-1, H, W)`` uint8 boundary
    maps as numpy."""
    return boundary_ops.boundary_prob_maps(
        torch.from_numpy(np.asarray(categorical_pred, np.float32)),
        bg_ilm=bg_ilm,
        bg_csi=bg_csi,
    ).numpy()


def md5(file_path: Path) -> str:
    log.info(f"Calculating md5 of file: {file_path}")
    with open(file_path, "rb") as file_to_check:
        return hashlib.md5(file_to_check.read()).hexdigest()


def load_model_and_config(model_path, **kwargs):
    """The workflows' model loader, :func:`.model_io.load_model_and_config`,
    where the JAX package's ``common/utils.py`` offers it too."""
    from .model_io import load_model_and_config as _impl

    return _impl(model_path, **kwargs)
