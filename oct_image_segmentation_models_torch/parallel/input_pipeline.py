"""Input pipeline, counterpart of the JAX package's
``parallel/input_pipeline.py``: per-node sharded HDF5 reads and batches
copied to the device ahead of the consumer.

- :class:`ShardedHDF5Reader` reads a split's strided sample shard of one
  node (sample i belongs to node ``i % nodes``), trimmed to floor(N /
  nodes) so that every node runs the same number of steps.
- :func:`device_prefetch` copies host batches from pinned memory to a
  device on a side stream, ``size`` batches ahead of the consumer; the
  consumer's stream waits on each copy's event, so neither the host nor
  the consumer's stream blocks on the copy.
- :func:`prefetch_to_mesh` does the same for a rank of a mesh, with this
  rank's rows of each node batch, on a producer thread, so that host batch
  assembly overlaps the device's work.

Under a profiler (:mod:`..common.profiling`) each batch's staging is a
``serve.stage`` span (``bytes``), and each wait of
:func:`prefetch_to_mesh`'s consumer for the producer an ``input.wait``.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from .._device import resolve_device
from ..common import h5, profiling


class ShardedHDF5Reader:
    """Reads a split's images and labels with per-node sample sharding.

    A JAX process is a node of the port's mesh: ``process_index`` and
    ``process_count`` default to ``mesh.node`` and ``mesh.nodes``, or to
    one node without a mesh. The shard is strided (sample i belongs to
    node ``i % process_count``), which keeps the class balance across
    nodes without a shuffle pass."""

    def __init__(
        self,
        path,
        split: str = "train",
        process_index: int = None,
        process_count: int = None,
        mesh=None,
    ):
        self.path = path
        self.split = split
        if process_index is None:
            process_index = mesh.node if mesh is not None else 0
        if process_count is None:
            process_count = mesh.nodes if mesh is not None else 1
        self.process_index, self.process_count = process_index, process_count

    def load(self):
        from ..common.dataset_loader import _load_split

        # The strided shard is selected inside the HDF5 read, so each node
        # reads only its own 1/nodes of the split.
        shard = slice(self.process_index, None, self.process_count)
        with h5.File(self.path, "r") as f:
            total = f[f"{self.split}_images"].shape[0]
            images, labels = _load_split(f, self.split, sample_slice=shard)
        if self.process_count > 1:
            # Every shard trimmed to the smallest one (floor(N / nodes)): a
            # node with one sample more would run one step more per epoch
            # and leave the others waiting in its collectives. The trimmed
            # samples are dropped without a log line, as in JAX.
            n = total // self.process_count
            images, labels = images[:n], labels[:n]
        return images, labels


def _tree_map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(fn(x) for x in batch)
    return fn(batch)


class _Uploader:
    """Host batches (an array or a tuple of arrays) to ``device``: on a
    card, pinned and copied on a side stream, the copy's event kept with
    the tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def start(self, batch):
        nbytes = sum(a.nbytes for a in batch) if isinstance(batch, (tuple, list)) else batch.nbytes
        with profiling.span("serve.stage", bytes=nbytes):
            host = _tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)), batch)
            if self.stream is None:
                return _tree_map(lambda t: t.to(self.device), host), None
            host = _tree_map(lambda t: t.pin_memory(), host)
            with torch.cuda.stream(self.stream):
                dev = _tree_map(lambda t: t.to(self.device, non_blocking=True), host)
                event = torch.cuda.Event()
                event.record(self.stream)
            return dev, event

    def finish(self, item):
        """The tensors, once the consumer's stream has waited for their copy."""
        dev, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            # The copy's memory belongs to the side stream: tell the caching
            # allocator that the consumer's stream uses it too.
            _tree_map(lambda t: t.record_stream(current), dev)
        return dev


def device_prefetch(batches: Iterable, size: int = 2, device=None) -> Iterator:
    """Iterate ``batches`` (numpy arrays or tuples of them) as tensors on
    ``device`` (None means CUDA), the copies started ``size`` batches
    ahead of the consumer."""
    uploader = _Uploader(resolve_device(device))
    it = iter(batches)
    buf = collections.deque()

    def fill():
        for batch in it:
            buf.append(uploader.start(batch))
            if len(buf) >= size:
                return

    fill()
    while buf:
        out = buf.popleft()
        fill()
        yield uploader.finish(out)


def prefetch_to_mesh(batches: Iterable, mesh, size: int = 2) -> Iterator:
    """Iterate node batches (numpy arrays or tuples of them) as this
    rank's rows (``mesh.local_rows``) on ``mesh.device``, ``size`` batches
    ahead of the consumer, assembled and copied on a background thread.
    An error of the source or of the copy reaches the consumer."""
    uploader = _Uploader(mesh.device)
    queue = collections.deque()
    ready = threading.Semaphore(0)
    space = threading.Semaphore(size)
    cancelled = threading.Event()
    done = object()

    def producer():
        # Any failure must reach the consumer: a producer that died silently
        # would leave it waiting on `ready` forever.
        try:
            for batch in batches:
                space.acquire()
                if cancelled.is_set():
                    return
                rows = _tree_map(lambda a: a[mesh.local_rows(len(a))], batch)
                queue.append(uploader.start(rows))
                ready.release()
            queue.append(done)
        except BaseException as exc:  # re-raised on the consumer's side
            queue.append(exc)
        ready.release()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            with profiling.span("input.wait"):
                ready.acquire()
            item = queue.popleft()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield uploader.finish(item)
            space.release()
    finally:
        # A consumer that stops early must release the producer, or it would
        # hold `size` device batches and the source alive.
        cancelled.set()
        space.release()
