"""Streaming OCT-volume inference, counterpart of the JAX package's
``prediction/streaming.py::VolumeSegmenter``.

A volume of B-scans goes through the fused pipeline
(:func:`..ops.inference.make_fused_pipeline`) in fixed-size batches. Each
batch is copied from pinned host memory with ``non_blocking=True``, and
the results stay on the device until the volume is done, so the host
queues the next batch while the card works on the current one.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..models import get_model_class
from ..ops.inference import make_fused_pipeline, select_optimized_forward


class VolumeSegmenter:
    """Reusable fused-pipeline runner for fixed-size B-scans."""

    def __init__(
        self,
        loaded_model,
        model_config: dict,
        batch_size: int = 8,
        bg_ilm: bool = True,
        bg_csi: bool = False,
        max_grad: int = 1,
        with_graph_search: bool = True,
        optimize: bool = True,
        compute_dtype: str = "float32",
        # "fast" = production min-path mode (cost-optimal, inside the
        # 0.05 px parity budget); "exact" = reference-heap tie parity.
        minpath_tie_parity: str = "fast",
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel serving over a mesh is not ported yet (ROADMAP A9)"
            )
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.device = resolve_device(device)
        self.loaded_model = loaded_model
        self.batch_size = batch_size
        container = get_model_class(loaded_model.name)(**model_config)
        self._model_div = container.spatial_divisor
        # The s2d labels forward for an eligible U-Net, else the BN-folded
        # one; ``kind`` says which ("s2d", "folded" or "parity").
        forward, self.kind = select_optimized_forward(
            loaded_model.module, compute_dtype=compute_dtype, optimize=optimize
        )
        self._pipeline = make_fused_pipeline(
            forward,
            container.get_preprocess_input_fn(),
            bg_ilm=bg_ilm,
            bg_csi=bg_csi,
            max_grad=max_grad,
            with_graph_search=with_graph_search,
            minpath_tie_parity=minpath_tie_parity,
            labels_apply_fn=forward if self.kind == "s2d" else None,
            num_classes=loaded_model.output_classes,
            return_maps=False,
            device=self.device,
        )

    def segment_volume(self, volume: np.ndarray):
        """Segment a ``(num_bscans, H, W, C)`` uint8 volume.

        Returns ``(labels u8 (N, H, W), boundary rows u16 (N, M, W))`` as
        numpy; rows are None without graph search."""
        n = volume.shape[0]
        if n == 0:
            raise ValueError(
                "segment_volume requires at least one B-scan "
                "(got an empty volume)"
            )
        b = self.batch_size
        pad = (-n) % b
        if pad:
            volume = np.concatenate([volume, volume[-1:].repeat(pad, 0)])
        model_div = self._model_div
        if volume.shape[1] % model_div or volume.shape[2] % model_div:
            raise ValueError(
                f"B-scan spatial dims {volume.shape[1]}x{volume.shape[2]} "
                f"must be multiples of {model_div} (the model's "
                f"spatial downsampling factor)"
            )

        pin = self.device.type == "cuda"
        labels_out, rows_out = [], []
        for i in range(0, len(volume), b):
            batch = torch.from_numpy(np.ascontiguousarray(volume[i : i + b]))
            if pin:
                batch = batch.pin_memory()
            labels, _maps, rows = self._pipeline(batch)
            labels_out.append(labels)
            if rows is not None:
                rows_out.append(rows)

        labels = torch.cat(labels_out).cpu().numpy()[:n]
        rows = torch.cat(rows_out).cpu().numpy()[:n] if rows_out else None
        return labels, rows
