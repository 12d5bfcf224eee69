"""Inference pipelines, counterparts of the JAX package's
``ops/inference.py``: :class:`StagedPipeline` (forward, conversion and
graph search as separate stages, for the predict and evaluate workflows)
and :func:`make_fused_pipeline` (the whole chain in one call, for
streaming volumes).

Two forwards feed the fused pipeline:

- the s2d labels forward (:mod:`.s2d_unet`, the default for an eligible
  U-Net): uint8 B-scans -> x/255 -> s2d conv stack -> per-phase softmax
  argmax labels in s2d layout -> s2d boundary maps -> min-path on the s2d
  maps (CUDA kernel ``minpath_delineate_s2d`` on the card) -> uint16 rows;
- a probability forward (the BN-folded or plain U-Net or DeepLabV3+):
  preprocess -> softmax -> argmax labels -> per-boundary maps -> min-path
  on the transposed maps (CUDA kernel ``minpath_delineate``) -> uint16
  rows.

The weights live in the modules, so the pipeline is ``fn(images)`` where
the JAX one is ``fn(variables, images)``. Over a mesh of ranks each rank
runs its rows of the batch through its own forward and min-path kernel,
with no collective on the device, and the outputs are gathered on the
host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .._device import compute_dtype as as_dtype
from .._device import module_dtype, precision, resolve_device
from ..common import profiling
from ..models import deeplabv3plus, transunet, unet
from ..parallel.mesh import all_gather_host
from . import boundary as boundary_ops
from . import minpath as minpath_ops
from .s2d_unet import d2s, maybe_build_s2d_apply


def select_optimized_forward(
    module: torch.nn.Module,
    compute_dtype: str = "float32",
    optimize: bool = True,
    s2d_output: str = "labels_s2d",
    fold_unet: bool = True,
):
    """Pick the inference forward -> ``(forward_module, kind)``, in the JAX
    selection order.

    ``kind`` is ``"s2d"`` for a U-Net the s2d transform takes (the forward
    is an :class:`.s2d_unet.S2DUNet` with output ``s2d_output``: with the
    default ``"labels_s2d"`` pass it to :func:`make_fused_pipeline`'s
    ``labels_apply_fn``; :class:`StagedPipeline` asks for ``"probs"``),
    ``"folded"`` for a DeepLabV3+, a float32 TransUNet (StdConv weights
    standardised once, decoder BN folded: :func:`..models.transunet.fold_transunet`)
    or another U-Net with ``fold_unet`` (BN folded into the convs), and
    ``"parity"`` without ``optimize`` or for another model (the module as
    given).

    ``compute_dtype="bfloat16"`` runs the s2d forward's or the folded
    DeepLabV3+'s conv stack in bfloat16 (head and softmax in float32). As
    in JAX it raises where neither applies (``optimize=False``, or a U-Net
    the s2d transform does not take: JAX has no bfloat16 folded U-Net),
    so that a bfloat16 request never runs float32."""
    dtype = as_dtype(compute_dtype)
    if optimize:
        s2d_fn, _div = maybe_build_s2d_apply(module, output=s2d_output, dtype=dtype)
        if s2d_fn is not None:
            return s2d_fn, "s2d"
        if isinstance(module, deeplabv3plus.DeeplabV3PlusModule):
            return unet.fold_batchnorm(module, dtype), "folded"
        if isinstance(module, transunet.TransUNetModule) and dtype == torch.float32:
            return transunet.fold_transunet(module), "folded"
        if fold_unet and isinstance(module, unet.UNetModule) and dtype == torch.float32:
            return unet.fold_batchnorm(module), "folded"
    if dtype != torch.float32:
        reason = "optimize=False" if not optimize else "the model has no optimized inference variant"
        raise ValueError(
            f"compute_dtype={compute_dtype!r} is only honored by the optimized "
            f"fast paths (s2d U-Net / BN-folded DeepLabV3+), which are "
            f"unavailable here ({reason}); use compute_dtype='float32' or an "
            "eligible model with optimize=True"
        )
    return module, "parity"


class StagedPipeline:
    """Inference over uint8 image batches in three stages (forward,
    conversion, graph search), counterpart of JAX ``StagedPipeline``, so
    that a caller can time each stage. Every stage returns tensors on
    ``device`` (None means CUDA).

    With ``optimize`` and a U-Net the s2d transform takes, the forward is
    the s2d probability forward for images whose H and W divide its
    factor; other images go through ``module`` itself. With ``optimize``
    a DeepLabV3+ runs BN-folded; another U-Net, and every model without
    ``optimize``, runs as given, as in JAX, which folds BatchNorm in this
    pipeline only for DeepLabV3+. The graph stage runs the min-path on the
    transposed image maps, which is the CUDA kernel ``minpath_delineate``
    (B1) on the card. In bfloat16 an image whose H or W misses the s2d
    factor raises instead of taking the float32 module.
    """

    def __init__(
        self,
        module: torch.nn.Module,
        preprocess_fn: Callable,
        bg_ilm: bool = True,
        bg_csi: bool = False,
        max_grad: int = 1,
        optimize: bool = True,
        compute_dtype: str = "float32",
        minpath_tie_parity: str = "exact",
        device=None,
    ):
        self.device = resolve_device(device)
        forward, kind = select_optimized_forward(
            module, compute_dtype, optimize, s2d_output="probs", fold_unet=False
        )
        self.kind = kind
        self._compute_dtype = as_dtype(compute_dtype)
        self._s2d = forward.to(self.device).eval() if kind == "s2d" else None
        self._s2d_div = 2**forward.s2d_levels if kind == "s2d" else 1
        self._module = (module if kind == "s2d" else forward).to(self.device).eval()
        self._preprocess = preprocess_fn
        self._bg_ilm, self._bg_csi = bg_ilm, bg_csi
        self._max_grad = max_grad
        self._tie_parity = minpath_tie_parity

    def predict_probs(self, images_u8) -> torch.Tensor:
        """``(B, H, W, C)`` uint8 -> ``(B, H, W, num_classes)`` float32
        probabilities."""
        images = torch.as_tensor(images_u8).to(self.device, non_blocking=True)
        h, w = images.shape[1], images.shape[2]
        s2d = self._s2d is not None and h % self._s2d_div == 0 and w % self._s2d_div == 0
        if self._s2d is not None and not s2d and self._compute_dtype != torch.float32:
            # The geometry fallback is the float32 module, as in JAX.
            raise ValueError(
                f"compute dtype {self._compute_dtype} requires the s2d fast "
                f"path, but image dims {h}x{w} do not divide its factor "
                f"{self._s2d_div}; pad the input or use compute_dtype='float32'"
            )
        forward = self._s2d if s2d else self._module
        with torch.inference_mode(), precision(module_dtype(forward)):
            x = self._preprocess(images.to(torch.float32))
            return forward(x)

    def convert(self, probs: torch.Tensor):
        """probs -> ``(argmax labels u8 (B, H, W), one-hot class-first
        categorical f32 (B, C, H, W), boundary maps u8 (B, C-1, H, W))``."""
        with torch.inference_mode():
            argmax_pred, categorical = boundary_ops.perform_argmax(probs, bin=True)
            maps = boundary_ops.boundary_maps_from_labels(
                argmax_pred, probs.shape[3], bg_ilm=self._bg_ilm, bg_csi=self._bg_csi
            )
            return argmax_pred.to(torch.uint8), categorical, maps

    def graph_search(self, maps: torch.Tensor):
        """Boundary maps ``(B, M, H, W)`` -> ``(rows u16 (B, M, W), region
        masks u8 (B, H, W))``."""
        with torch.inference_mode():
            rows = minpath_ops.delineate_image_maps(
                maps, max_grad=self._max_grad, tie_parity=self._tie_parity
            )
            masks = boundary_ops.create_area_mask(rows.to(torch.float32), maps.shape[-2])
            return rows.to(torch.uint16), masks


class FusedPipeline(torch.nn.Module):
    """The fused chain as a module: ``forward(images_u8)`` -> ``(labels,
    maps | None, rows | None)`` on the images' device, with no
    ``inference_mode`` and no precision switch of its own, so that
    ``torch.export`` can trace it (:mod:`..common.export`).
    :func:`make_fused_pipeline` calls it under both."""

    def __init__(
        self,
        forward: torch.nn.Module,
        preprocess_fn: Callable,
        s2d_labels: bool,
        num_classes: int = None,
        bg_ilm: bool = True,
        bg_csi: bool = False,
        max_grad: int = 1,
        with_graph_search: bool = True,
        minpath_backend: str = "auto",
        minpath_tie_parity: str = "exact",
        return_maps: bool = True,
    ):
        super().__init__()
        self.forward_fn = forward
        self._preprocess = preprocess_fn
        self._s2d_labels = s2d_labels
        self._num_classes = num_classes
        self._bg_ilm, self._bg_csi = bg_ilm, bg_csi
        self._max_grad = max_grad
        self._graph_search = with_graph_search
        self._backend = minpath_backend
        self._tie_parity = minpath_tie_parity
        self._return_maps = return_maps

    def _s2d_tail(self, lab_s2d):
        with profiling.span("serve.maps"):
            labels = d2s(lab_s2d)[..., 0]
            # One ridge pass in the s2d domain; the image orientation is a
            # permutation of its output.
            maps_s2d = boundary_ops.boundary_maps_from_s2d_labels(
                lab_s2d, self._num_classes, bg_ilm=self._bg_ilm, bg_csi=self._bg_csi,
                transposed="s2d",
            )
            maps = boundary_ops.s2d_maps_to_image(maps_s2d) if self._return_maps else None
        if not self._graph_search:
            return labels, maps, None
        with profiling.span("serve.minpath"):
            rows = minpath_ops.delineate_s2d(
                maps_s2d,
                max_grad=self._max_grad,
                tie_parity=self._tie_parity,
                backend=self._backend,
            )
            return labels, maps, rows.to(torch.uint16)

    def forward(self, images: torch.Tensor):
        # The spans are off while torch.export or a compiler traces this
        # module (profiling.tracing), so an exported program holds no
        # profiler op.
        with profiling.span("serve.forward"):
            out = self.forward_fn(self._preprocess(images.to(torch.float32)))
        if self._s2d_labels:
            return self._s2d_tail(out)
        with profiling.span("serve.maps"):
            argmax_pred, categorical = boundary_ops.perform_argmax(out, bin=True)
            maps = boundary_ops.boundary_prob_maps(
                categorical, bg_ilm=self._bg_ilm, bg_csi=self._bg_csi
            )
            labels = argmax_pred.to(torch.uint8)
        maps_out = maps if self._return_maps else None
        if not self._graph_search:
            return labels, maps_out, None
        with profiling.span("serve.minpath"):
            rows = minpath_ops.delineate_image_maps(
                maps,
                max_grad=self._max_grad,
                tie_parity=self._tie_parity,
                backend=self._backend,
            )
            return labels, maps_out, rows.to(torch.uint16)


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
    mesh=None,
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
    to ``device``, and runs in its own compute dtype under that dtype's
    precision context. The chain is :class:`FusedPipeline`.

    ``mesh`` (a :class:`..parallel.mesh.Mesh`) makes the pipeline
    data-parallel: every rank calls it with the same batch, which must
    split evenly over the ranks; each rank runs its rows
    (``mesh.world_rows``) on ``mesh.device``, and every rank gets the whole
    batch's outputs, gathered over the host group, as CPU tensors."""
    if labels_apply_fn is not None and num_classes is None:
        raise ValueError(
            "make_fused_pipeline: labels_apply_fn requires num_classes "
            "(the s2d labels carry no channel axis to infer it from)"
        )
    device = resolve_device(mesh.device if mesh is not None and device is None else device)
    forward = labels_apply_fn if labels_apply_fn is not None else module
    chain = FusedPipeline(
        forward.to(device).eval(),
        preprocess_fn,
        s2d_labels=labels_apply_fn is not None,
        num_classes=num_classes,
        bg_ilm=bg_ilm,
        bg_csi=bg_csi,
        max_grad=max_grad,
        with_graph_search=with_graph_search,
        minpath_backend=minpath_backend,
        minpath_tie_parity=minpath_tie_parity,
        return_maps=return_maps,
    )

    forward_precision = module_dtype(forward)

    def pipeline(images):
        # serve.launch: the host's enqueue of the whole chain on one batch.
        with profiling.span("serve.launch", bscans=len(images)):
            images = torch.as_tensor(images).to(device, non_blocking=True)
            with torch.inference_mode(), precision(forward_precision):
                return chain(images)

    if mesh is None:
        return pipeline

    def sharded(images):
        images = torch.as_tensor(images)
        local = [
            None if t is None else t.cpu().numpy()
            for t in pipeline(images[mesh.world_rows(images.shape[0])])
        ]
        parts = all_gather_host(local, mesh)
        return tuple(
            None if t is None else torch.from_numpy(np.concatenate([part[i] for part in parts]))
            for i, t in enumerate(local)
        )

    return sharded
