"""Device resolution, float32 precision and per-device constants for the
port's entry points."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device that is not there raises:
    the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


@contextlib.contextmanager
def float32_precision():
    """Run float32 convolutions and matmuls in full float32, as the JAX
    reference does.

    cuDNN convolutions default to TF32 on the card (about three decimal
    digits). ``cudnn.flags`` turns cuDNN off unless ``enabled=True`` is
    passed, so it is passed. ``matmul.allow_tf32`` is already False by
    default; it is set here too so that a caller's global setting cannot
    leak into the forward.
    """
    prev_matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_matmul


class PerDevice:
    """A host array as a float32 tensor, copied to each device once, so
    that a step that uses it never waits for the host after the first."""

    def __init__(self, array):
        self._array = np.asarray(array, np.float32)
        self._tensors = {}

    def __len__(self) -> int:
        return len(self._array)

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._tensors:
            self._tensors[device] = torch.from_numpy(self._array).to(device)
        return self._tensors[device]
