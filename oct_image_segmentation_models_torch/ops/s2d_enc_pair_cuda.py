"""Wrapper of the hand-written CUDA encoder-pair kernel
(``csrc/s2d_enc_pair.cu``).

The kernel replaces the Pallas TPU kernel
``oct_image_segmentation_models_tpu/ops/s2d_pallas.py::fused_enc_pair``
and computes what :func:`.s2d_enc_pair.fused_enc_pair_reference` computes,
to float32 accuracy (3xTF32 on the tensor cores). ``fused_enc_pair_cuda.
launches`` counts its launches and ``.tile_launches`` splits them by the
CTA tile the C entry picks for 4C (``"8x16"`` block rows x columns while
the y1 tile fits in shared memory, else ``"4x8"``; :func:`enc_pair_tile`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .s2d_enc_pair import check_enc_pair_args


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("s2d_enc_pair")
    fn = lib.s2d_enc_pair
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.s2d_enc_pair_tile.argtypes = [ctypes.c_int]
    lib.s2d_enc_pair_tile.restype = ctypes.c_int
    return lib


def enc_pair_tile(c4: int) -> str:
    """The kernel's CTA tile for 4C = ``c4``, as ``"TRxTC"`` block rows x
    columns; raises for a 4C the kernel refuses."""
    code = _library().s2d_enc_pair_tile(c4)
    if code == 0:
        raise ValueError(f"fused_enc_pair_cuda: no tile fits 4C={c4} in shared memory")
    return f"{code // 100}x{code % 100}"


def fused_enc_pair_cuda(x, w1, b1, w2, b2):
    """``(y2, pooled)`` of one s2d encoder level, on PyTorch's current
    stream. All tensors float32, contiguous, on one CUDA device; 4Cin a
    multiple of 4 and 4C a multiple of 8. Raises on anything else."""
    if not x.is_cuda:
        raise ValueError(f"fused_enc_pair_cuda needs CUDA tensors, got {x.device}")
    check_enc_pair_args(x, w1, b1, w2, b2)
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if not t.is_contiguous():
            raise ValueError(f"fused_enc_pair_cuda needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_enc_pair_cuda needs a 16-byte aligned {name}")
    B, nh, nw, cin4 = x.shape
    c4 = w1.shape[-1]
    if cin4 % 4 or c4 % 8:
        raise ValueError(
            f"fused_enc_pair_cuda takes 4Cin % 4 == 0 and 4C % 8 == 0, "
            f"got 4Cin={cin4}, 4C={c4}"
        )
    if min(B, nh, nw) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    tile = enc_pair_tile(c4)
    y2 = torch.empty((B, nh, nw, c4), dtype=torch.float32, device=x.device)
    pooled = torch.empty((B, nh, nw, c4 // 4), dtype=torch.float32, device=x.device)
    fn = _library().s2d_enc_pair
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(),
            w1.data_ptr(),
            b1.data_ptr(),
            w2.data_ptr(),
            b2.data_ptr(),
            y2.data_ptr(),
            pooled.data_ptr(),
            B,
            nh,
            nw,
            cin4,
            c4,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"s2d_enc_pair kernel launch failed: cudaError_t {err}")
    fused_enc_pair_cuda.launches += 1
    fused_enc_pair_cuda.tile_launches[tile] += 1
    return y2, pooled


fused_enc_pair_cuda.launches = 0
fused_enc_pair_cuda.tile_launches = {"8x16": 0, "4x8": 0}
