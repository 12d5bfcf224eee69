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
- :class:`FetchRing` copies device batches back to the host the other
  way: each batch into a pinned slot on a side stream of its own as soon
  as it is queued, then out into the returned arrays once its copy is done.
  Both rings keep their slots and events in a :class:`HostSlots`.
- :func:`prefetch_to_mesh` does the same for a rank of a mesh, with this
  rank's rows of each node batch, on a producer thread, so that host batch
  assembly overlaps the device's work, through one :class:`StagingRing` a
  call.

Under a profiler (:mod:`..common.profiling`) each batch's staging is a
``serve.stage`` span (``bytes``, ``slot_alloc``, ``slot_wait``), each
batch's copy out of a :class:`FetchRing` a ``serve.fetch`` span with the
same counts, and each wait of :func:`prefetch_to_mesh`'s consumer for the
producer an ``input.wait``.
"""

from __future__ import annotations

import collections
import functools
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


def _running(event) -> bool:
    """True while the copy that recorded ``event`` (None: no copy) runs."""
    return event is not None and not event.query()


@functools.lru_cache(maxsize=None)
def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class HostSlots:
    """A ring of host slots of one batch each (a list of tensors of one set
    of shapes and dtypes), pinned where ``pin``, with per slot the event of
    the last copy that used it. It is allocated for a set of shapes, dtypes
    and depth, and again only when these change. :meth:`claim` looks at the
    next slot, :meth:`take` hands it over once it is free, :meth:`advance`
    gives it its new copy's event and moves on."""

    def __init__(self, pin: bool):
        self.pin = pin
        self._key = None
        self._want = None
        self._slots = []  # per slot: (host tensors, numpy views of them)
        self._events = []  # per slot: its last copy's event, None when done
        self._next = 0

    def claim(self, specs, n: int):
        """``(alloc, busy)`` for the next slot of a ring of ``n`` for tensors
        of ``specs`` (``[(shape, torch dtype)]``): whether the ring must be
        allocated for them, and whether the slot's last copy still runs.
        Waits for nothing."""
        self._want = (n, tuple((tuple(shape), dtype) for shape, dtype in specs))
        if self._want != self._key:
            return True, False
        return False, _running(self._events[self._next])

    def take(self):
        """The claimed slot's ``(tensors, numpy views)``: the ring allocated
        where the claim found it must be, else the slot's last copy waited
        for."""
        if self._want != self._key:
            self._allocate(self._want)
        else:
            event = self._events[self._next]
            if event is not None:
                event.synchronize()
        return self._slots[self._next]

    def advance(self, event):
        """Give the slot taken last its new copy's ``event``, and move on."""
        self._events[self._next] = event
        self._next = (self._next + 1) % len(self._slots)

    def _allocate(self, key):
        for event in self._events:  # no copy may still use a slot let go
            if event is not None:
                event.synchronize()
        n, specs = key
        self._slots = []
        for _ in range(n):
            host = [torch.empty(shape, dtype=dtype, pin_memory=self.pin) for shape, dtype in specs]
            self._slots.append((host, [t.numpy() for t in host]))
        self._events = [None] * n
        self._next = 0
        self._key = key


class StagingRing:
    """Host batches (numpy arrays or tuples of them) to ``device`` through a
    ring of preallocated slots of one batch each (:class:`HostSlots`),
    pinned on a card (plain tensors elsewhere), kept from batch to batch
    and from one :meth:`prefetch` to the next.

    Each batch is copied straight from the caller's arrays, whatever their
    strides, into the next slot, then to the device on a side stream, and
    the copy's event is kept with the tensors; :meth:`finish` makes the
    consumer's stream wait for it. A slot is refilled only once the event
    of its previous copy has completed; the host waits for it where it has
    not. The ring holds ``size + 1`` slots for the batches' shapes and
    dtypes, and is allocated again only when these or ``size`` change.
    Under a profiler ``serve.stage`` counts ``slot_alloc`` (1 where the
    stage allocated the ring) and ``slot_wait`` (1 where it found the
    slot's previous copy still running). One thread stages at a time."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._slots = HostSlots(pin=self.stream is not None)

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

    def finish(self, item):
        """A staged batch's tensors, once the consumer's stream has waited
        for their copy."""
        out, dev, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            # The copy's memory belongs to the side stream: tell the caching
            # allocator that the consumer's stream uses it too.
            for t in dev:
                t.record_stream(current)
        return out

    def _stage(self, batch, slots: int):
        arrays = list(batch) if isinstance(batch, (tuple, list)) else [batch]
        alloc, busy = self._slots.claim([(a.shape, _torch_dtype(a.dtype)) for a in arrays], slots)
        nbytes = sum(a.nbytes for a in arrays)
        with profiling.span("serve.stage", bytes=nbytes, slot_alloc=int(alloc), slot_wait=int(busy)):
            host, views = self._slots.take()
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
            self._slots.advance(event)
        return (type(batch)(dev) if isinstance(batch, (tuple, list)) else dev[0]), dev, event


class FetchRing:
    """Device batches back to the host through a ring of slots of one batch
    each (:class:`HostSlots`), pinned on a card (plain tensors elsewhere),
    on a side stream of its own, kept from one :meth:`fetch` to the next.

    Each batch's copy into the next slot is enqueued as soon as the batch's
    tensors are: the side stream waits for the consumer's stream, copies
    ``non_blocking`` and records the copy's event, and the caching
    allocator is told that the side stream uses the tensors. The host
    copies a batch out of its slot into the returned arrays once that event
    has completed: after each batch, every batch whose copy is done,
    without waiting; it waits only for the batch whose slot the next one
    needs, and at the end. The returned arrays are the caller's; no slot is
    handed out. Under a profiler each batch's copy out is a ``serve.fetch``
    span (``bytes``; ``slot_alloc``, 1 where the batch allocated the ring;
    ``slot_wait``, 1 where the host waited for its copy), and each wait at
    the end (at least one a call) a ``serve.drain``. One :meth:`fetch` at a
    time."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._slots = HostSlots(pin=self.stream is not None)

    def fetch(self, batches: Iterable, count: int, size: int = 2) -> tuple:
        """The first ``count`` rows of ``batches``, joined on the host.
        ``batches`` yields tuples of device tensors (or None) whose first
        dimension is the batch; the result is a tuple of numpy arrays, None
        where the tuples hold None. The ring holds ``size + 1`` slots."""
        slots = size + 1
        pending = collections.deque()  # per batch: (its rows, slot views, event, bytes, alloc)
        out, done = None, 0
        for batch in batches:
            tensors = [t for t in batch if t is not None]
            if len(pending) == slots:  # the next slot still holds a batch
                self._copy_out(out, *pending.popleft())
            alloc, _ = self._slots.claim([(t.shape, t.dtype) for t in tensors], slots)
            host, views = self._slots.take()
            if out is None:
                present = [t is not None for t in batch]
                out = [np.empty((count, *v.shape[1:]), v.dtype) for v in views]
            if self.stream is None:
                for h, t in zip(host, tensors):
                    h.copy_(t)
                event = None
            else:
                self.stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self.stream):
                    for h, t in zip(host, tensors):
                        h.copy_(t, non_blocking=True)
                        t.record_stream(self.stream)
                    event = torch.cuda.Event()
                    event.record(self.stream)
            self._slots.advance(event)
            rows = slice(done, min(done + len(tensors[0]), count))
            pending.append((rows, views, event, sum(t.nbytes for t in tensors), alloc))
            done = rows.stop
            while pending and not _running(pending[0][2]):
                self._copy_out(out, *pending.popleft())
        # The end: the host waits for each batch still out in turn, under
        # serve.drain, and copies it out while the card runs the later ones.
        for _ in range(max(len(pending), 1)):
            with profiling.span("serve.drain"):
                if pending and pending[0][2] is not None:
                    pending[0][2].synchronize()
            if pending:
                self._copy_out(out, *pending.popleft())
        arrays = iter(out)
        return tuple(next(arrays) if p else None for p in present)

    @staticmethod
    def _copy_out(out, rows: slice, views, event, nbytes: int, alloc: bool):
        busy = _running(event)
        with profiling.span("serve.fetch", bytes=nbytes, slot_alloc=int(alloc), slot_wait=int(busy)):
            if busy:
                event.synchronize()
            for a, view in zip(out, views):
                np.copyto(a[rows], view[: rows.stop - rows.start])


def device_prefetch(batches: Iterable, size: int = 2, device=None) -> Iterator:
    """Iterate ``batches`` (numpy arrays or tuples of them) as tensors on
    ``device`` (None means CUDA), the copies started ``size`` batches
    ahead of the consumer, through a ring of its own."""
    return StagingRing(resolve_device(device)).prefetch(batches, size)


def prefetch_to_mesh(batches: Iterable, mesh, size: int = 2) -> Iterator:
    """Iterate node batches (numpy arrays or tuples of them) as this
    rank's rows (``mesh.local_rows``) on ``mesh.device``, ``size`` batches
    ahead of the consumer, assembled and copied on a background thread.
    An error of the source or of the copy reaches the consumer.

    The rows are staged through one :class:`StagingRing` of ``size + 1``
    slots, pinned once a call (again only where a batch's shapes change).
    At most ``size`` batches are staged and not yet let go of by the
    consumer, the one it holds included, so the slot being filled held a
    batch that the consumer has let go of, and is refilled once that
    batch's copy has completed. Only the producer thread touches the
    ring's slots."""
    ring = StagingRing(mesh.device)
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
                if isinstance(batch, (tuple, list)):
                    rows = type(batch)(a[mesh.local_rows(len(a))] for a in batch)
                else:
                    rows = batch[mesh.local_rows(len(batch))]
                queue.append(ring._stage(rows, size + 1))
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
            yield ring.finish(item)
            space.release()
    finally:
        # A consumer that stops early must release the producer, or it would
        # hold `size` device batches and the source alive.
        cancelled.set()
        space.release()
