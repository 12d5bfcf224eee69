"""PyTorch/CUDA port of the OCT B-scan segmentation framework.

Counterpart of :mod:`oct_image_segmentation_models_tpu`, written for an
NVIDIA H100: plain tensor code is PyTorch, and each Pallas TPU kernel of
the JAX package is a CUDA kernel written by hand for Hopper: the min-path
dynamic program on ``(N, W, H)`` and on s2d maps (``csrc/minpath.cu``)
and the fused s2d encoder pair (``csrc/s2d_enc_pair.cu``).

Module names mirror the JAX package so each counterpart is easy to find.
Public functions keep the JAX layouts: images ``(B, H, W, C)`` uint8,
probabilities channels-last, min-path maps ``(..., W, H)`` uint8, rows
``(..., W)``; in the s2d domain activations ``(B, H/2, W/2, 4C)`` with
channels ``(q_h, q_w, c)``, labels ``(B, H/2, W/2, 4)`` and maps
``(B, M, H/2, W/2, 4)`` with channels ``(q_h, q_w)``. Every entry point takes ``device=None``, which means
``"cuda"``; without a CUDA device it raises and asks for
``device="cpu"``.

This package imports neither JAX nor anything of the JAX package.
"""

__version__ = "0.1.0"
