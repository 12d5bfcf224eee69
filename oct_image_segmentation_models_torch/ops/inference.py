"""End-to-end inference pipeline, counterpart of the JAX package's
``ops/inference.py::make_fused_pipeline``.

Two forwards feed it:

- the s2d labels forward (:mod:`.s2d_unet`, the default for an eligible
  U-Net): uint8 B-scans -> x/255 -> s2d conv stack -> per-phase softmax
  argmax labels in s2d layout -> s2d boundary maps -> min-path on the s2d
  maps (CUDA kernel ``minpath_delineate_s2d`` on the card) -> uint16 rows;
- a probability forward (the BN-folded or plain U-Net): x/255 -> softmax
  -> argmax labels -> per-boundary maps -> min-path on the transposed
  maps (CUDA kernel ``minpath_delineate``) -> uint16 rows.

The weights live in the modules, so the pipeline is ``fn(images)`` where
the JAX one is ``fn(variables, images)``. Mesh sharding is not ported
(ROADMAP A9).
"""

from __future__ import annotations

from typing import Callable

import torch

from .._device import float32_precision, resolve_device
from ..models.unet import UNetModule, fold_batchnorm
from . import boundary as boundary_ops
from . import minpath as minpath_ops
from .s2d_unet import d2s, maybe_build_s2d_apply


def select_optimized_forward(
    module: torch.nn.Module,
    compute_dtype: str = "float32",
    optimize: bool = True,
):
    """Pick the inference forward -> ``(forward_module, kind)``, in the JAX
    selection order.

    ``kind`` is ``"s2d"`` for a U-Net the s2d transform takes (the forward
    is an :class:`.s2d_unet.S2DUNet` with output ``"labels_s2d"``; pass it
    to :func:`make_fused_pipeline`'s ``labels_apply_fn``), ``"folded"`` for
    another U-Net (BN folded into
    the convs), and ``"parity"`` without ``optimize`` or for another
    model (the module as given). Only float32 is ported, so another
    ``compute_dtype`` raises (the bfloat16 s2d forward is ROADMAP A13)."""
    if compute_dtype != "float32":
        raise ValueError(
            f"compute_dtype={compute_dtype!r}: the PyTorch forward runs "
            "float32 only"
        )
    if optimize:
        s2d_fn, _div = maybe_build_s2d_apply(module, output="labels_s2d")
        if s2d_fn is not None:
            return s2d_fn, "s2d"
        if isinstance(module, UNetModule):
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
    labels_apply_fn: torch.nn.Module = None,
    num_classes: int = None,
    return_maps: bool = True,
    device=None,
) -> Callable:
    """End-to-end pipeline on ``device`` (None means CUDA):
    ``fn(images_u8 (B, H, W, C)) -> (labels u8 (B, H, W), boundary maps
    u8 (B, M, H, W) | None, rows u16 (B, M, W) | None)``, all tensors on
    ``device``. ``return_maps=False`` gives None in the maps slot.

    ``module`` maps preprocessed images to probabilities. Where
    ``labels_apply_fn`` is given (preprocessed x -> uint8 argmax labels in
    s2d layout, from ``build_s2d_apply(..., output="labels_s2d")``), it
    replaces ``module``: the boundary maps and the min-path stay in the
    s2d domain. It needs ``num_classes``. The forward that runs is moved
    to ``device``."""
    if labels_apply_fn is not None and num_classes is None:
        raise ValueError(
            "make_fused_pipeline: labels_apply_fn requires num_classes "
            "(the s2d labels carry no channel axis to infer it from)"
        )
    device = resolve_device(device)
    if labels_apply_fn is not None:
        labels_apply_fn = labels_apply_fn.to(device).eval()
    else:
        module = module.to(device).eval()

    def s2d_tail(lab_s2d):
        labels = d2s(lab_s2d)[..., 0]
        # One ridge pass in the s2d domain; the image orientation is a
        # permutation of its output.
        maps_s2d = boundary_ops.boundary_maps_from_s2d_labels(
            lab_s2d, num_classes, bg_ilm=bg_ilm, bg_csi=bg_csi, transposed="s2d"
        )
        maps = boundary_ops.s2d_maps_to_image(maps_s2d) if return_maps else None
        if not with_graph_search:
            return labels, maps, None
        rows = minpath_ops.delineate_s2d(
            maps_s2d,
            max_grad=max_grad,
            tie_parity=minpath_tie_parity,
            backend=minpath_backend,
        )
        return labels, maps, rows.to(torch.uint16)

    def pipeline(images):
        images = torch.as_tensor(images).to(device, non_blocking=True)
        with torch.inference_mode(), float32_precision():
            x = preprocess_fn(images.to(torch.float32))
            if labels_apply_fn is not None:
                return s2d_tail(labels_apply_fn(x))
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
