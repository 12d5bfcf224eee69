"""The min-path kernels as registered PyTorch operators.

- ``octseg::minpath_delineate(Tensor maps, int max_grad, bool exact) ->
  Tensor`` takes ``(..., W, H)`` uint8 maps and gives ``(..., W)`` int32
  rows. Its CUDA implementation is the hand-written kernel B1
  (:func:`.minpath_cuda.delineate_cuda`), its CPU implementation the plain
  version :func:`.minpath.delineate_reference`.
- ``octseg::minpath_delineate_s2d(Tensor maps, int max_grad, bool exact)
  -> Tensor`` takes s2d maps ``(B, M, Hb, Wb, 4)`` and gives ``(B, M,
  2 Wb)`` rows: B2 (:func:`.minpath_cuda.delineate_cuda_s2d`) on the card,
  :func:`.minpath.delineate_s2d_reference` on the CPU.

The kernels are launched through ``ctypes``, which neither FX nor
``torch.export`` can trace. As operators they are one opaque node of a
traced graph, with a fake implementation that gives the output's shape
(symbolic sizes included), and the operator's own dispatch by device picks
the kernel or the plain version when the graph runs. Importing this module
(or :mod:`.minpath`, which imports it) registers both operators; an
exported program that calls them needs it imported before it is loaded.
"""

from __future__ import annotations

import torch

from . import minpath


def _tie(exact: bool) -> str:
    return "exact" if exact else "fast"


@torch.library.custom_op("octseg::minpath_delineate", mutates_args=(), device_types="cpu")
def minpath_delineate(maps: torch.Tensor, max_grad: int, exact: bool) -> torch.Tensor:
    return minpath.delineate_reference(maps, max_grad=max_grad, tie_parity=_tie(exact))


@minpath_delineate.register_kernel("cuda")
def _minpath_delineate_cuda(maps: torch.Tensor, max_grad: int, exact: bool) -> torch.Tensor:
    from .minpath_cuda import delineate_cuda

    return delineate_cuda(maps.contiguous(), max_grad=max_grad, tie_parity=_tie(exact))


@minpath_delineate.register_fake
def _minpath_delineate_fake(maps, max_grad, exact):
    return maps.new_empty(maps.shape[:-1], dtype=torch.int32)


@torch.library.custom_op(
    "octseg::minpath_delineate_s2d", mutates_args=(), device_types="cpu"
)
def minpath_delineate_s2d(maps: torch.Tensor, max_grad: int, exact: bool) -> torch.Tensor:
    return minpath.delineate_s2d_reference(
        maps, max_grad=max_grad, tie_parity=_tie(exact)
    )


@minpath_delineate_s2d.register_kernel("cuda")
def _minpath_delineate_s2d_cuda(maps: torch.Tensor, max_grad: int, exact: bool):
    from .minpath_cuda import delineate_cuda_s2d

    return delineate_cuda_s2d(maps.contiguous(), max_grad=max_grad, tie_parity=_tie(exact))


@minpath_delineate_s2d.register_fake
def _minpath_delineate_s2d_fake(maps, max_grad, exact):
    if maps.ndim != 5 or maps.shape[-1] != 4:
        raise ValueError(
            f"s2d maps must have shape (B, M, Hb, Wb, 4), got {tuple(maps.shape)}"
        )
    b, m, _, wb, _ = maps.shape
    return maps.new_empty((b, m, 2 * wb), dtype=torch.int32)
