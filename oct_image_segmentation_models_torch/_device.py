"""Device resolution, compute dtypes, precision contexts and per-device
constants for the port's entry points."""

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


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype) -> torch.dtype:
    """``dtype`` ("float32", "bfloat16" or the torch dtype) as a torch
    dtype; any other dtype raises."""
    name = str(dtype).removeprefix("torch.")
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype!r}")
    return COMPUTE_DTYPES[name]


@contextlib.contextmanager
def bfloat16_precision():
    """Run a bfloat16 forward or step as XLA does: bfloat16 convolutions
    and matmuls accumulate in float32, and the float32 parts (head,
    softmax, loss) run in full float32 (:func:`float32_precision`).

    ``matmul.allow_bf16_reduced_precision_reduction`` defaults to True,
    which lets cuBLAS reduce split-K partial sums in bfloat16; it is off
    inside the context and restored after."""
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with float32_precision():
            yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev


def precision(dtype=torch.float32):
    """The precision context of a forward or step that computes in
    ``dtype``: :func:`bfloat16_precision` or :func:`float32_precision`."""
    if compute_dtype(dtype) == torch.bfloat16:
        return bfloat16_precision()
    return float32_precision()


def module_dtype(module: torch.nn.Module) -> torch.dtype:
    """The compute dtype of a port module (its ``compute_dtype``)."""
    return getattr(module, "compute_dtype", torch.float32)


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
