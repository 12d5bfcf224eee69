"""Input pipeline, counterpart of the JAX package's
``parallel/input_pipeline.py``: per-node sharded HDF5 reads and batches
copied to the device ahead of the consumer.

- :class:`ShardedHDF5Reader` reads a split's strided sample shard of one
  node (sample i belongs to node ``i % nodes``), trimmed to floor(N /
  nodes) so that every node runs the same number of steps.
- :func:`device_prefetch` copies host batches to a device on a side
  stream, ``size`` batches ahead of the consumer, through a
  :class:`StagingRing` of pinned slots; the consumer's stream waits on each
  copy's event, so neither the host nor the consumer's stream blocks on the
  copy. A caller that streams many inputs keeps one ring and calls its
  :meth:`StagingRing.prefetch`, so that the slots are pinned once.
- :func:`prefetch_to_mesh` does the same for a rank of a mesh, with this
  rank's rows of each node batch, on a producer thread, so that host batch
  assembly overlaps the device's work; it pins each batch on its own.

Under a profiler (:mod:`..common.profiling`) each batch's staging is a
``serve.stage`` span (``bytes``; through a ring also ``slot_alloc`` and
``slot_wait``), and each wait of :func:`prefetch_to_mesh`'s consumer for
the producer an ``input.wait``.
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
    card, each pinned on its own and copied on a side stream, the copy's
    event kept with the tensors."""

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


class StagingRing(_Uploader):
    """An uploader whose host side is a ring of preallocated slots of one
    batch each, pinned on a card (plain tensors elsewhere), kept from batch
    to batch and from one :meth:`prefetch` to the next.

    Each batch is copied straight from the caller's arrays, whatever their
    strides, into the next slot, then copied to the device as
    :class:`_Uploader` copies it. A slot is refilled only once the event of
    its previous copy has completed; the host waits for it where it has
    not. The ring holds ``size + 1`` slots for the batches' shapes and
    dtypes, and is allocated again only when these or ``size`` change.
    Under a profiler ``serve.stage`` counts ``slot_alloc`` (1 where the
    stage allocated the ring) and ``slot_wait`` (1 where it found the
    slot's previous copy still running). One :meth:`prefetch` at a time."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self._key = None
        self._slots = []  # per slot: (host tensors, numpy views of them)
        self._events = []  # per slot: its last copy's event, None when done
        self._next = 0

    def prefetch(self, batches: Iterable, size: int = 2) -> Iterator:
        """Iterate ``batches`` (numpy arrays or tuples of them) as tensors on
        the device, the copies started ``size`` batches ahead of the
        consumer."""
        it = iter(batches)
        buf = collections.deque()

        def fill():
            for batch in it:
                buf.append(self._stage(batch, size + 1))
                if len(buf) >= size:
                    return

        fill()
        while buf:
            out = buf.popleft()
            fill()
            yield self.finish(out)

    def _stage(self, batch, slots: int):
        arrays = list(batch) if isinstance(batch, (tuple, list)) else [batch]
        key = (slots, tuple((a.shape, a.dtype) for a in arrays))
        alloc = key != self._key
        k = 0 if alloc else self._next
        event = None if alloc else self._events[k]
        busy = event is not None and not event.query()
        nbytes = sum(a.nbytes for a in arrays)
        with profiling.span("serve.stage", bytes=nbytes, slot_alloc=int(alloc), slot_wait=int(busy)):
            if alloc:
                self._allocate(key, arrays, slots)
            elif busy:
                event.synchronize()
            host, views = self._slots[k]
            for view, a in zip(views, arrays):
                np.copyto(view, a)
            if self.stream is None:
                # A copy, as on a card: the slot is refilled while the
                # consumer may still hold the batch.
                dev, event = [t.to(self.device, copy=True) for t in host], None
            else:
                with torch.cuda.stream(self.stream):
                    dev = [t.to(self.device, non_blocking=True) for t in host]
                    event = torch.cuda.Event()
                    event.record(self.stream)
            self._events[k] = event
            self._next = (k + 1) % slots
        return (type(batch)(dev) if isinstance(batch, (tuple, list)) else dev[0]), event

    def _allocate(self, key, arrays, slots: int):
        for event in self._events:  # no copy may still read a slot let go
            if event is not None:
                event.synchronize()
        pin = self.stream is not None
        self._slots = []
        for _ in range(slots):
            host = [
                torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype, pin_memory=pin)
                for a in arrays
            ]
            self._slots.append((host, [t.numpy() for t in host]))
        self._events = [None] * slots
        self._key = key


def device_prefetch(batches: Iterable, size: int = 2, device=None) -> Iterator:
    """Iterate ``batches`` (numpy arrays or tuples of them) as tensors on
    ``device`` (None means CUDA), the copies started ``size`` batches
    ahead of the consumer, through a ring of its own."""
    return StagingRing(resolve_device(device)).prefetch(batches, size)


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
