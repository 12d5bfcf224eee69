"""The DeepLabV3+ resize that trains under deterministic algorithms
(``models/deeplabv3plus.py::DeterministicResize``) against
``F.interpolate`` and the JAX package's ``_resize_bilinear``, on the CPU.

On the card PyTorch's bilinear backward adds with atomics; under
``torch.use_deterministic_algorithms`` a CUDA resize that needs its
gradient goes through ``DeterministicResize`` instead, whose backward is
the resize's weight matrices applied to the gradient. Here, at the
resizes the model makes (and odd and non-integer factors):

- its forward is ``F.interpolate``'s bit for bit;
- in float64 its gradient is autograd's through ``F.interpolate`` within
  1e-12 (measured 9e-15);
- in float32 its gradient is the VJP of JAX's ``_resize_bilinear`` within
  1e-5 of the gradient's max (measured 3.4e-7: sums of a few terms
  taken in another order);
- on the CPU, deterministic algorithms or not, ``resize_bilinear`` keeps
  ``F.interpolate``'s own backward, which is deterministic there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from oct_image_segmentation_models_tpu.models import deeplabv3plus as jax_deeplab
from oct_image_segmentation_models_torch.models import deeplabv3plus as port_deeplab

from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

F64_ATOL = 1e-12
JAX_REL = 1e-5
# NHWC input shape, output (h, w): the resizes of test_torch_deeplab.py.
RESIZES = [
    ((2, 3, 4, 256), (12, 16)),  # DSPP -> (H//4, W//4) at 48x64
    ((2, 12, 16, 256), (48, 64)),  # decoder -> (H, W) at 48x64
    ((2, 1, 1, 256), (3, 4)),  # the pooled branch's broadcast
    ((1, 5, 7, 3), (20, 28)),  # odd sizes
    ((1, 3, 5, 2), (13, 21)),  # a factor that is not an integer
]


def _inputs(shape, size, dtype):
    rng = np.random.default_rng(sum(shape) + sum(size))
    x = rng.normal(size=shape).astype(dtype)
    g = rng.normal(size=(shape[0], *size, shape[3])).astype(dtype)
    return x, g


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


def _port_vjp(fn, x, g):
    xt = _nchw(x).requires_grad_(True)
    y = fn(xt)
    (grad,) = torch.autograd.grad(y, xt, _nchw(g))
    return y.detach(), grad.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,size", RESIZES)
def test_forward_bit_equal_and_float64_gradient_is_autograds(shape, size):
    x, g = _inputs(shape, size, np.float64)
    y, got = _port_vjp(lambda t: port_deeplab.DeterministicResize.apply(t, *size), x, g)
    y0, want = _port_vjp(
        lambda t: F.interpolate(t, size=size, mode="bilinear", align_corners=False), x, g
    )
    assert torch.equal(y, y0)
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)


@pytest.mark.parametrize("shape,size", RESIZES)
def test_float32_gradient_is_jax_resize_vjp(shape, size):
    x, g = _inputs(shape, size, np.float32)
    _, got = _port_vjp(lambda t: port_deeplab.DeterministicResize.apply(t, *size), x, g)
    _, vjp = jax.vjp(lambda a: jax_deeplab._resize_bilinear(a, *size), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_REL * scale)


@pytest.mark.parametrize("deterministic", [False, True])
def test_cpu_keeps_interpolates_backward(deterministic):
    x = torch.randn(1, 2, 3, 5, requires_grad=True)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        y = port_deeplab.resize_bilinear(x, 12, 20)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert type(y.grad_fn).__name__.startswith("UpsampleBilinear2D")
