"""Wrapper of the hand-written CUDA min-path kernel (``csrc/minpath.cu``).

The kernel replaces the Pallas TPU kernel
``oct_image_segmentation_models_tpu/ops/minpath_pallas.py::delineate_pallas``
and is bit-equal to :func:`.minpath.delineate_reference` in both tie modes.
``delineate_cuda.launches`` counts the kernel's launches, so a run can show
that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .minpath import validate_max_grad_packing

MAX_HEIGHT = 1024  # one thread per row, one CTA per map


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("minpath")
    fn = lib.minpath_delineate
    fn.argtypes = [
        ctypes.c_void_p,  # maps
        ctypes.c_void_p,  # choices scratch
        ctypes.c_void_p,  # rows
        ctypes.c_int,  # n
        ctypes.c_int,  # w
        ctypes.c_int,  # h
        ctypes.c_int,  # max_grad
        ctypes.c_int,  # exact
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


def delineate_cuda(
    maps_u8: torch.Tensor, max_grad: int = 1, tie_parity: str = "exact"
) -> torch.Tensor:
    """``(..., W, H)`` uint8 CUDA maps -> ``(..., W)`` int32 rows, on
    PyTorch's current stream. Raises on anything the kernel does not take."""
    if not maps_u8.is_cuda:
        raise ValueError(f"delineate_cuda needs a CUDA tensor, got {maps_u8.device}")
    if maps_u8.dtype != torch.uint8:
        raise TypeError(f"delineate_cuda needs uint8 maps, got {maps_u8.dtype}")
    if maps_u8.ndim < 2:
        raise ValueError("maps must have shape (..., W, H)")
    if not maps_u8.is_contiguous():
        raise ValueError("delineate_cuda needs contiguous (..., W, H) maps")
    if tie_parity not in ("exact", "fast"):
        raise ValueError(f"unknown tie_parity: {tie_parity}")
    if max_grad < 0:
        raise ValueError(f"max_grad must be >= 0, got {max_grad}")
    validate_max_grad_packing(max_grad)
    lead = tuple(maps_u8.shape[:-2])
    w, h = maps_u8.shape[-2], maps_u8.shape[-1]
    if not 1 <= h <= MAX_HEIGHT:
        raise ValueError(f"delineate_cuda takes 1 <= H <= {MAX_HEIGHT}, got H={h}")
    if w < 1:
        raise ValueError(f"delineate_cuda needs W >= 1, got W={w}")
    maps = maps_u8.reshape(-1, w, h)
    n = maps.shape[0]
    rows = torch.empty((n, w), dtype=torch.int32, device=maps.device)
    if n == 0:
        return rows.reshape(lead + (w,))
    choices = torch.empty((n, w, h), dtype=torch.uint8, device=maps.device)
    fn = _library().minpath_delineate
    with torch.cuda.device(maps.device):
        stream = torch.cuda.current_stream(maps.device).cuda_stream
        err = fn(
            maps.data_ptr(),
            choices.data_ptr(),
            rows.data_ptr(),
            n,
            w,
            h,
            max_grad,
            int(tie_parity == "exact"),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"minpath kernel launch failed: cudaError_t {err}")
    delineate_cuda.launches += 1
    return rows.reshape(lead + (w,))


delineate_cuda.launches = 0
