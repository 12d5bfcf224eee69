"""Profiling hooks, counterparts of the JAX package's
``common/profiling.py``: :func:`trace`, a ``torch.profiler`` capture
written as a Chrome trace (viewable in Perfetto or ``chrome://tracing``),
and :class:`DeviceStopwatch`, which times device work despite
asynchronous launches."""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Optional

import torch

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
