"""PyTorch/CUDA port of the OCT B-scan segmentation framework.

Counterpart of :mod:`oct_image_segmentation_models_tpu`, written for an
NVIDIA H100: plain tensor code is PyTorch, and the min-path dynamic
program that the JAX package runs as a Pallas TPU kernel is a CUDA
kernel written by hand for Hopper (``csrc/minpath.cu``).

Module names mirror the JAX package so each counterpart is easy to find.
Public functions keep the JAX layouts: images ``(B, H, W, C)`` uint8,
probabilities channels-last, min-path maps ``(..., W, H)`` uint8, rows
``(..., W)``. Every entry point takes ``device=None``, which means
``"cuda"``; without a CUDA device it raises and asks for
``device="cpu"``.

This package imports neither JAX nor anything of the JAX package.
"""

__version__ = "0.1.0"
