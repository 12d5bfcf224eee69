"""Profiling hook of the training driver, counterpart of the JAX package's
``common/profiling.py::trace``: a ``torch.profiler`` capture written as a
Chrome trace (viewable in Perfetto or ``chrome://tracing``)."""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path
from typing import Optional

import torch

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
