"""Streaming OCT-volume inference, counterpart of the JAX package's
``prediction/streaming.py::VolumeSegmenter``.

A volume of B-scans goes through the fused pipeline
(:func:`..ops.inference.make_fused_pipeline`) in fixed-size batches. Whole
batches are views of the caller's volume; only a short last batch is
built, padded with the volume's last B-scan. The segmenter's
:class:`..parallel.input_pipeline.StagingRing` copies each batch into a
pinned slot that it keeps for its lifetime and from there to the device on
a side stream, ``prefetch`` batches ahead. Its
:class:`..parallel.input_pipeline.FetchRing` copies each batch's labels and
rows back into pinned slots on another side stream as soon as the batch is
queued, and the host copies them out into the returned arrays once each
copy is done, so the host queues the next batch while the card works on
the current one, and the volume's end waits only for the last copy.

Over a mesh of ranks every rank passes the same volume: each segments an
equal contiguous chunk of it on its own device (the tail padded with the
last B-scan), and the chunks are gathered on the host, so every rank
returns the whole volume's outputs, equal to a one-rank run's.

Under a profiler a call records the spans of :mod:`..common.profiling`:
``serve.volume`` (a request), ``serve.pad``, ``serve.stage`` (per batch,
``parallel/input_pipeline.py``), ``serve.launch`` with ``serve.forward``,
``serve.maps`` and ``serve.minpath`` (per batch, ``ops/inference.py``),
``serve.fetch`` (per batch) and ``serve.drain`` (``FetchRing``) and, over a
mesh, ``serve.gather``.
"""

from __future__ import annotations

import threading

import numpy as np

from .._device import resolve_device
from ..common import profiling
from ..models import get_model_class
from ..ops.inference import make_fused_pipeline, select_optimized_forward
from ..parallel.input_pipeline import FetchRing, StagingRing
from ..parallel.mesh import all_gather_host


def _batches(part: np.ndarray, count: int, b: int, fill: np.ndarray):
    """The batches of ``b`` B-scans that cover ``count`` rows: views of
    ``part`` while it fills whole batches, then each batch past that built
    from the rest of ``part`` and copies of ``fill`` (the volume's last
    B-scan), under a ``serve.pad`` span of the B-scans it adds."""
    whole = len(part) // b * b
    for i in range(0, whole, b):
        yield part[i : i + b]
    for i in range(whole, count, b):
        rest = part[i : i + b]
        with profiling.span("serve.pad", bscans=b - len(rest)):
            batch = np.empty((b, *part.shape[1:]), part.dtype)
            batch[: len(rest)] = rest
            batch[len(rest) :] = fill
        yield batch


class VolumeSegmenter:
    """Reusable fused-pipeline runner for fixed-size B-scans.

    With ``mesh`` (a :class:`..parallel.mesh.Mesh`) the pipeline runs on
    ``mesh.device``, and ``batch_size`` is a node's batch, as it is a JAX
    process's: each rank runs batches of ``batch_size // mesh.local_size``
    B-scans, as each device of the JAX process's mesh does."""

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
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if mesh is not None and batch_size % mesh.local_size:
            raise ValueError(
                f"batch_size={batch_size} must be a multiple of the node's "
                f"{mesh.local_size} ranks for data-parallel inference"
            )
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.loaded_model = loaded_model
        self.batch_size = batch_size
        self._rank_batch = batch_size // (mesh.local_size if mesh is not None else 1)
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
        # The host slots that every volume's batches are staged through and
        # its outputs fetched back through, and the lock that gives them to
        # one volume at a time.
        self._staging = StagingRing(self.device)
        self._fetching = FetchRing(self.device)
        self._staging_lock = threading.Lock()

    def segment_volume(self, volume: np.ndarray, prefetch: int = 2):
        """Segment a ``(num_bscans, H, W, C)`` uint8 volume, copying
        ``prefetch`` batches ahead.

        Returns ``(labels u8 (N, H, W), boundary rows u16 (N, M, W))`` as
        numpy; rows are None without graph search. Over a mesh every rank
        passes the same volume and gets the same outputs."""
        n = volume.shape[0]
        if n == 0:
            raise ValueError(
                "segment_volume requires at least one B-scan "
                "(got an empty volume)"
            )
        # Padding: the B-scans that all ranks' batches compute beyond the volume's.
        world = self.mesh.world if self.mesh is not None else 1
        chunk = -(-n // world)
        padded = world * -(-chunk // self._rank_batch) * self._rank_batch - n
        with profiling.span("serve.volume", request=True, bscans=n, padded=padded):
            if self.mesh is not None:
                return self._segment_volume_multiproc(volume, prefetch)
            return self._segment_local(volume, n, volume[-1], prefetch)

    def _segment_volume_multiproc(self, volume: np.ndarray, prefetch: int):
        n = volume.shape[0]
        world, rank = self.mesh.world, self.mesh.rank
        # Equal chunks (the last ranks padded with the final B-scan), so that
        # the gathered outputs stack in rank order.
        chunk = -(-n // world)
        lo = min(rank * chunk, n)
        labels, rows = self._segment_local(volume[lo : lo + chunk], chunk, volume[-1], prefetch)
        with profiling.span("serve.gather", bytes=labels.nbytes + (0 if rows is None else rows.nbytes)):
            parts = all_gather_host((labels, rows), self.mesh)
        labels = np.concatenate([p[0] for p in parts])[:n]
        rows = None if parts[0][1] is None else np.concatenate([p[1] for p in parts])[:n]
        return labels, rows

    def _segment_local(self, part: np.ndarray, count: int, fill: np.ndarray, prefetch: int):
        """The outputs of ``count`` rows: ``part``'s B-scans, then ``fill``."""
        model_div = self._model_div
        if part.shape[1] % model_div or part.shape[2] % model_div:
            raise ValueError(
                f"B-scan spatial dims {part.shape[1]}x{part.shape[2]} "
                f"must be multiples of {model_div} (the model's "
                f"spatial downsampling factor)"
            )

        batches = _batches(part, count, self._rank_batch, fill)
        with self._staging_lock:
            staged = self._staging.prefetch(batches, size=prefetch)
            outputs = ((labels, rows) for labels, _maps, rows in map(self._pipeline, staged))
            return self._fetching.fetch(outputs, count, size=prefetch)
