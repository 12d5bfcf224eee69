"""One run of one cell: what ``run.py`` hands a driver and what the driver
hands back."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    workload: str
    config: dict  # portbench/configs/<config>.json
    traffic: dict  # portbench/traffic/<mix>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    limits: dict  # portbench/limits/<workload>.json
    started: float = field(default_factory=time.perf_counter)  # the process's start

    @property
    def model(self) -> dict:
        """The model's keyword arguments (the container's config)."""
        return self.config["model"]["kwargs"]


@dataclass
class Outcome:
    end_to_end: dict  # metric name -> value
    context: dict  # what the per-layer readers read
    attempted: int
    failed: int
    correct: bool
    checks: dict  # name -> {"value", "limit"}
    memory_peak_bytes: int
    trace: object = None  # harness.trace.Trace of the traced window
    notes: dict = field(default_factory=dict)  # printed to stderr only


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def launch_counts() -> dict:
    """The port's kernel launch counters (``ops/minpath_cuda.py``,
    ``ops/s2d_enc_pair_cuda.py``)."""
    from oct_image_segmentation_models_torch.ops.minpath_cuda import delineate_cuda, delineate_cuda_s2d
    from oct_image_segmentation_models_torch.ops.s2d_enc_pair_cuda import fused_enc_pair_cuda

    return {
        "minpath_delineate": delineate_cuda.launches,
        "minpath_delineate_s2d": delineate_cuda_s2d.launches,
        "s2d_enc_pair": fused_enc_pair_cuda.launches,
    }
