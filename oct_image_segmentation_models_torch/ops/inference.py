"""End-to-end inference pipeline, counterpart of the JAX package's
``ops/inference.py::make_fused_pipeline``.

    uint8 B-scans -> x/255 -> U-Net forward (plain or BN-folded) ->
    softmax argmax labels -> per-boundary uint8 maps -> min-path
    delineation (CUDA kernel on the card) -> uint16 rows

The weights live in the module, so the pipeline is ``fn(images)`` where
the JAX one is ``fn(variables, images)``. The JAX package's s2d labels
forward and its mesh sharding are not ported here (ROADMAP A10, A9).
"""

from __future__ import annotations

from typing import Callable

import torch

from .._device import float32_precision, resolve_device
from ..models.unet import UNetModule, fold_batchnorm
from . import boundary as boundary_ops
from . import minpath as minpath_ops


def select_optimized_forward(
    module: torch.nn.Module, compute_dtype: str = "float32", optimize: bool = True
):
    """Pick the inference forward -> ``(forward_module, kind)``.

    ``kind`` is ``"folded"`` (BN folded into the convs) for a U-Net when
    ``optimize``, else ``"parity"`` (the module as given). Only float32 is
    ported, so another ``compute_dtype`` raises."""
    if compute_dtype != "float32":
        raise ValueError(
            f"compute_dtype={compute_dtype!r}: the PyTorch forward runs "
            "float32 only"
        )
    if optimize and isinstance(module, UNetModule):
        return fold_batchnorm(module), "folded"
    return module, "parity"


def make_fused_pipeline(
    module: torch.nn.Module,
    preprocess_fn: Callable,
    bg_ilm: bool = True,
    bg_csi: bool = False,
    max_grad: int = 1,
    with_graph_search: bool = True,
    minpath_backend: str = "auto",
    minpath_tie_parity: str = "exact",
    return_maps: bool = True,
    device=None,
) -> Callable:
    """End-to-end pipeline on ``device`` (None means CUDA):
    ``fn(images_u8 (B, H, W, C)) -> (labels u8 (B, H, W), boundary maps
    u8 (B, M, H, W) | None, rows u16 (B, M, W) | None)``, all tensors on
    ``device``. ``module`` is moved there. ``return_maps=False`` gives
    None in the maps slot."""
    device = resolve_device(device)
    module = module.to(device).eval()

    def pipeline(images):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        with torch.inference_mode(), float32_precision():
            x = preprocess_fn(images.to(torch.float32))
            probs = module(x)
            argmax_pred, categorical = boundary_ops.perform_argmax(probs, bin=True)
            maps = boundary_ops.boundary_prob_maps(
                categorical, bg_ilm=bg_ilm, bg_csi=bg_csi
            )
            labels = argmax_pred.to(torch.uint8)
            maps_out = maps if return_maps else None
            if not with_graph_search:
                return labels, maps_out, None
            rows = minpath_ops.delineate_image_maps(
                maps,
                max_grad=max_grad,
                tie_parity=minpath_tie_parity,
                backend=minpath_backend,
            )
            return labels, maps_out, rows.to(torch.uint16)

    return pipeline
