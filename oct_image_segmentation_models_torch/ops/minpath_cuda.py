"""Wrappers of the hand-written CUDA min-path kernel (``csrc/minpath.cu``).

- :func:`delineate_cuda` takes ``(..., W, H)`` maps. It replaces the Pallas
  TPU kernel ``oct_image_segmentation_models_tpu/ops/minpath_pallas.py::
  delineate_pallas`` and is bit-equal to :func:`.minpath.delineate_reference`.
- :func:`delineate_cuda_s2d` takes s2d maps ``(B, M, Hb, Wb, 4)`` and reads
  them in place (the kernel's s2d layout). It replaces
  ``delineate_pallas_s2d`` and is bit-equal to
  :func:`.minpath.delineate_s2d_reference`.

Both hold in both tie modes. ``delineate_cuda.launches`` and
``delineate_cuda_s2d.launches`` count each entry's launches, so a run can
show which of them its path went through.
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
    for fn in (lib.minpath_delineate, lib.minpath_delineate_s2d):
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


def _check(maps_u8: torch.Tensor, max_grad: int, tie_parity: str, name: str):
    if not maps_u8.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {maps_u8.device}")
    if maps_u8.dtype != torch.uint8:
        raise TypeError(f"{name} needs uint8 maps, got {maps_u8.dtype}")
    if not maps_u8.is_contiguous():
        raise ValueError(f"{name} needs contiguous maps")
    if tie_parity not in ("exact", "fast"):
        raise ValueError(f"unknown tie_parity: {tie_parity}")
    if max_grad < 0:
        raise ValueError(f"max_grad must be >= 0, got {max_grad}")
    validate_max_grad_packing(max_grad)


def _launch(entry: str, maps, n: int, w: int, h: int, max_grad: int, tie_parity: str):
    """Launch one C entry on ``n`` maps of ``w`` columns and ``h`` rows;
    returns ``(n, w)`` int32 rows."""
    if not 1 <= h <= MAX_HEIGHT:
        raise ValueError(f"the min-path kernel takes 1 <= H <= {MAX_HEIGHT}, got H={h}")
    if w < 1:
        raise ValueError(f"the min-path kernel needs W >= 1, got W={w}")
    rows = torch.empty((n, w), dtype=torch.int32, device=maps.device)
    if n == 0:
        return rows
    choices = torch.empty((n, w, h), dtype=torch.uint8, device=maps.device)
    fn = getattr(_library(), entry)
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
    return rows


def delineate_cuda(
    maps_u8: torch.Tensor, max_grad: int = 1, tie_parity: str = "exact"
) -> torch.Tensor:
    """``(..., W, H)`` uint8 CUDA maps -> ``(..., W)`` int32 rows, on
    PyTorch's current stream. Raises on anything the kernel does not take."""
    if maps_u8.ndim < 2:
        raise ValueError("maps must have shape (..., W, H)")
    _check(maps_u8, max_grad, tie_parity, "delineate_cuda")
    lead = tuple(maps_u8.shape[:-2])
    w, h = maps_u8.shape[-2], maps_u8.shape[-1]
    maps = maps_u8.reshape(-1, w, h)
    rows = _launch("minpath_delineate", maps, maps.shape[0], w, h, max_grad, tie_parity)
    if maps.shape[0]:
        delineate_cuda.launches += 1
    return rows.reshape(lead + (w,))


delineate_cuda.launches = 0


def delineate_cuda_s2d(
    maps_s2d_u8: torch.Tensor, max_grad: int = 1, tie_parity: str = "exact"
) -> torch.Tensor:
    """s2d maps ``(B, M, Hb, Wb, 4)`` uint8 on the card, channels
    ``(q_h, q_w)``, standing for image maps ``(B, M, 2 Hb, 2 Wb)`` ->
    ``(B, M, 2 Wb)`` int32 rows, on PyTorch's current stream."""
    if maps_s2d_u8.ndim != 5 or maps_s2d_u8.shape[-1] != 4:
        raise ValueError(
            f"s2d maps must have shape (B, M, Hb, Wb, 4), got {tuple(maps_s2d_u8.shape)}"
        )
    _check(maps_s2d_u8, max_grad, tie_parity, "delineate_cuda_s2d")
    B, M, hb, wb, _ = maps_s2d_u8.shape
    n, w, h = B * M, 2 * wb, 2 * hb
    rows = _launch("minpath_delineate_s2d", maps_s2d_u8, n, w, h, max_grad, tie_parity)
    if n:
        delineate_cuda_s2d.launches += 1
    return rows.reshape(B, M, w)


delineate_cuda_s2d.launches = 0
