"""The benchmark's plain reference: plain PyTorch, nothing of the port."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(precise: bool = True):
    """Full float32 convolutions and matmuls (TF32 off), or with
    ``precise=False`` TF32 on the tensor cores, the control's precision."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = not precise
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=not precise):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
