"""Profiling hooks, counterparts of the JAX package's
``common/profiling.py``: :func:`trace`, a ``torch.profiler`` capture
written as a Chrome trace (viewable in Perfetto or ``chrome://tracing``),
:class:`DeviceStopwatch`, which times device work despite asynchronous
launches, and the port's spans.

A span (:func:`span`) names a step of the program. It is on exactly while
a ``torch.profiler`` session runs (:func:`trace`, training's
``profile_dir``, or a caller's own ``torch.profiler.profile``) and no
compiler or ``torch.export`` traces the code; otherwise it is one shared
no-op context. On, it opens ``torch.profiler.record_function(name)``, so
it lands in the exported trace as a ``user_annotation``, and appends a
:class:`Span` to an in-memory list that :func:`spans`, :func:`span_totals`
and :func:`reset_spans` read and clear. A span's start and end are Unix
nanoseconds, the clock of the exported trace: an event's ``ts`` (µs)
plus the trace's ``baseTimeNanoseconds``, so a span lines up with the
device's events without parsing the trace."""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from .._device import resolve_device

TRACE_FILENAME = "trace.json"


@contextlib.contextmanager
def trace(profile_dir: Optional[Path], filename: str = TRACE_FILENAME):
    """Capture host activity, and the card's when CUDA is available, into
    ``profile_dir/filename``; a no-op when ``profile_dir`` is None."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    profile_dir = Path(profile_dir)
    profile_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logging.getLogger(__name__).info("profiling into %s", profile_dir)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(profile_dir / filename))


class DeviceStopwatch:
    """``start(value=None)`` / ``stop(value=None) -> seconds`` around
    device work, as the JAX package's stopwatch.

    On a card (``device`` None or CUDA) each mark is a
    ``torch.cuda.Event(enable_timing=True)`` recorded on the current
    stream: it fires when the work enqueued before it, ``value``'s
    included, is done, and ``stop`` waits for its event. On the CPU, where
    every op has finished when it returns (so ``value`` is already
    materialized), each mark reads ``time.perf_counter``."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._t0 = None

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def start(self, value=None):
        self._t0 = self._mark()

    def stop(self, value=None) -> float:
        t1 = self._mark()
        if self.device.type != "cuda":
            return t1 - self._t0
        t1.synchronize()
        return self._t0.elapsed_time(t1) / 1e3


@dataclass(eq=False)
class Span:
    """One recorded span. ``parent`` is the span open on the same thread
    when it began; ``request`` the id that the outermost request span
    (``span(..., request=True)``) above it opened; ``counts`` the integers
    it was given (B-scans, bytes)."""

    name: str
    parent: Optional["Span"]
    request: Optional[int]
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    counts: dict = field(default_factory=dict)


_RECORDS: list = []
_OPEN = threading.local()
_REQUEST_IDS = itertools.count(1)
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """True while a ``torch.profiler`` session runs and no compiler or
    ``torch.export`` traces the code: when :func:`span` records."""
    return _autograd_profiler._is_profiler_enabled and not torch.compiler.is_compiling()


def span(name: str, request: bool = False, **counts):
    """A context naming a step of the program; ``request=True`` opens a new
    request id that every span beneath it carries. Off (see
    :func:`tracing`) it is one shared no-op context: no
    ``record_function``, no clock read, no record."""
    if not tracing():
        return _OFF
    return _recorded(name, request, counts)


@contextlib.contextmanager
def _recorded(name: str, request: bool, counts: dict):
    stack = _OPEN.__dict__.setdefault("stack", [])
    parent = stack[-1] if stack else None
    rid = next(_REQUEST_IDS) if request else (parent.request if parent else None)
    record = Span(name, parent, rid, threading.get_ident(), counts=counts)
    stack.append(record)
    try:
        with torch.profiler.record_function(name):
            record.start_ns = time.time_ns()
            try:
                yield
            finally:
                record.end_ns = time.time_ns()
    finally:
        stack.pop()
        _RECORDS.append(record)


def spans() -> list:
    """The recorded :class:`Span` s, in the order they ended."""
    return list(_RECORDS)


def reset_spans() -> None:
    _RECORDS.clear()


def _covered_ns(intervals) -> int:
    """The length of the union of ``[(start, end)]``."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def span_totals() -> dict:
    """Per span name: ``count``, ``total_ns``, ``self_ns`` (each span's
    duration less the union of its child spans' intervals) and ``counts``
    (the sums of the spans' counts)."""
    records = spans()
    children = {}
    for r in records:
        if r.parent is not None:
            children.setdefault(r.parent, []).append(r)
    totals = {}
    for r in records:
        t = totals.setdefault(r.name, {"count": 0, "total_ns": 0, "self_ns": 0, "counts": {}})
        duration = r.end_ns - r.start_ns
        inside = [(max(c.start_ns, r.start_ns), min(c.end_ns, r.end_ns)) for c in children.get(r, ())]
        t["count"] += 1
        t["total_ns"] += duration
        t["self_ns"] += duration - _covered_ns((a, b) for a, b in inside if b > a)
        for k, v in r.counts.items():
            t["counts"][k] = t["counts"].get(k, 0) + v
    return totals
