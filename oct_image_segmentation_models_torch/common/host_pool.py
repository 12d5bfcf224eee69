"""Process pool for the per-image host phase of predict and evaluate,
counterpart of the JAX package's ``common/host_pool.py``.

The workflows run the device pipeline batched up front; what is left per
image (metrics, HDF5/CSV writes, matplotlib PNGs) is numpy, scipy, HDF5
and matplotlib work. This module fans it out over a spawn pool. Tasks
carry numpy arrays, never tensors, and each worker hides the card from
itself before it runs a task, so no worker initializes CUDA.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence


def hide_cuda_from_worker() -> None:
    """Spawn-pool initializer: no CUDA device is visible in the worker,
    so nothing a task runs can reach the card."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def resolve_num_workers(num_workers) -> int:
    """Validated worker count for the host-side artifact pool.

    ``"auto"`` is ``min(4, cpu_count - 1)``: 0 (serial, in process) on
    hosts of one or two cores, where starting workers costs more than it
    saves."""
    if num_workers == "auto":
        return max(0, min(4, (os.cpu_count() or 1) - 1))
    if not isinstance(num_workers, int) or isinstance(num_workers, bool) \
            or num_workers < 0:
        raise ValueError(
            f"num_workers must be an int >= 0 or 'auto', got {num_workers!r}"
        )
    return num_workers


def map_host_tasks(fn: Callable, tasks: Sequence, num_workers: int) -> List:
    """``[fn(t) for t in tasks]``, fanned over a spawn process pool when
    ``num_workers > 1``. ``fn`` must be a module-level (picklable)
    function of host work; results keep task order."""
    if num_workers > 1 and len(tasks) > 1:
        import multiprocessing

        workers = min(num_workers, len(tasks))
        with multiprocessing.get_context("spawn").Pool(
            workers, initializer=hide_cuda_from_worker
        ) as pool:
            return pool.map(fn, tasks)
    return [fn(task) for task in tasks]
