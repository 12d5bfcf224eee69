"""Fused s2d encoder pair, counterpart of the JAX package's
``ops/s2d_pallas.py``.

One s2d encoder level (two 3x3 conv + ReLU blocks, BN folded, then a 2x2
max-pool) in block space is

    x (B, nh, nw, 4Cin)  --conv U->S-->  y1 (B, nh+1, nw+1, 4C)
                         --conv S->U-->  y2 (B, nh, nw, 4C)   [skip out]
                         --phase max --> pooled (B, nh, nw, C) [next level]

(:mod:`.s2d_unet` for the block-space transform). Two implementations
share this contract:

- :func:`fused_enc_pair_reference`, the plain unfused chain in PyTorch;
- :func:`.s2d_enc_pair_cuda.fused_enc_pair_cuda`, the hand-written CUDA
  kernel (``csrc/s2d_enc_pair.cu``) that keeps ``y1`` in shared memory and
  runs both convs on the tensor cores in 3xTF32.

:func:`fused_enc_pair` runs the kernel for a CUDA tensor and the plain
version for a CPU tensor.
"""

from __future__ import annotations

import torch

from .s2d_unet import _enc_pair_nchw

__all__ = ["enc_pair_supported", "fused_enc_pair", "fused_enc_pair_reference"]


def _pick_tr(nh: int) -> int:
    for tr in (8, 4, 2):
        if nh % tr == 0:
            return tr
    return 0


def enc_pair_supported(nh: int, nw: int, cin4: int, c4: int) -> bool:
    """Whether an s2d encoder level goes through the fused kernel: the
    JAX gate, kept as it is so that a level takes the kernel in the port
    exactly when it does in JAX (block rows divisible by 2, 4 or 8 and
    channel counts that are multiples of 128)."""
    return _pick_tr(nh) > 0 and cin4 % 128 == 0 and c4 % 128 == 0


def check_enc_pair_args(x, w1, b1, w2, b2) -> None:
    """Raise on shapes and dtypes that are not an encoder pair."""
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_enc_pair needs float32 {name}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.ndim != 4:
        raise ValueError(f"x must be (B, nh, nw, 4Cin), got {tuple(x.shape)}")
    cin4 = x.shape[-1]
    c4 = w1.shape[-1]
    if tuple(w1.shape) != (2, 2, cin4, c4):
        raise ValueError(f"w1 must be (2, 2, {cin4}, 4C), got {tuple(w1.shape)}")
    if tuple(w2.shape) != (2, 2, c4, c4):
        raise ValueError(f"w2 must be (2, 2, {c4}, {c4}), got {tuple(w2.shape)}")
    if tuple(b1.shape) != (c4,) or tuple(b2.shape) != (c4,):
        raise ValueError(f"biases must be ({c4},)")
    if c4 % 4:
        raise ValueError(f"4C must be a multiple of 4, got {c4}")


def fused_enc_pair_reference(x, w1, b1, w2, b2):
    """The unfused chain of the s2d forward (conv U->S + ReLU + shifted-edge
    masks, conv S->U + ReLU, then the phase max-pool), run on its NCHW ops
    with one permute in and one out. Returns ``(y2, pooled)``."""
    check_enc_pair_args(x, w1, b1, w2, b2)

    def nchw(t, *dims):
        # Contiguous, as the forward holds them: a permuted view is
        # channels-last to PyTorch, a layout the forward never runs.
        return t.permute(*dims).contiguous()

    y2, pooled = _enc_pair_nchw(
        nchw(x, 0, 3, 1, 2), nchw(w1, 3, 2, 0, 1), b1, nchw(w2, 3, 2, 0, 1), b2
    )
    return y2.permute(0, 2, 3, 1).contiguous(), pooled.permute(0, 2, 3, 1).contiguous()


def fused_enc_pair(x, w1, b1, w2, b2):
    """Fused s2d encoder pair.

    Args:
      x: (B, nh, nw, 4Cin) unshifted s2d activations, float32.
      w1: (2, 2, 4Cin, 4C) U->S transformed kernel (``transform_kernel(w,
        0, 1)``, block taps e in {-1, 0}).
      b1: (4C,) phase-tiled bias.
      w2: (2, 2, 4C, 4C) S->U transformed kernel (e in {0, 1}).
      b2: (4C,) phase-tiled bias.

    Returns ``(y2, pooled)``: the (B, nh, nw, 4C) skip tensor and the
    (B, nh, nw, C) phase-max-pooled next-level input. A CUDA ``x`` runs
    the CUDA kernel (or raises); a CPU ``x`` runs the plain version.
    """
    if x.is_cuda:
        from .s2d_enc_pair_cuda import fused_enc_pair_cuda

        return fused_enc_pair_cuda(x, w1, b1, w2, b2)
    return fused_enc_pair_reference(x, w1, b1, w2, b2)
