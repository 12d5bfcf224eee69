"""DeepLabV3+ in PyTorch, counterpart of the JAX package's
``models/deeplabv3plus.py``.

Structure (op for op the JAX ``DeeplabV3PlusModule``):
- the ResNet50 backbone (:mod:`.resnet`), tapped at
  ``conv4_block6_2_relu`` (stride 16) and ``conv2_block3_2_relu`` (stride 4);
- Dilated Spatial Pyramid Pooling: the image-level mean through a 1x1
  block with a bias, resized back; a 1x1 block and 3x3 blocks at
  dilations 6, 12 and 18; their concat in that order; a 1x1 projection;
- the decoder: a bilinear resize to (H//4, W//4), the concat with a
  48-filter 1x1 block of the low tap (the DSPP output first), two 3x3
  blocks, a bilinear resize to (H, W);
- a float32 1x1 head and softmax.

A block is Conv (no bias unless asked, He-normal) -> BatchNorm (eps 1e-3)
-> ReLU, the U-Net's :class:`.unet.ConvBlock`. Every resize upsamples, so
``F.interpolate(mode="bilinear", align_corners=False)`` is
``jax.image.resize(method="bilinear")``; the two agree to float32
rounding, not bit for bit. On the card PyTorch's bilinear backward adds
with atomics, so under ``torch.use_deterministic_algorithms`` a resize
that needs its gradient takes :class:`DeterministicResize`, whose
backward contracts the gradient with the resize's weight matrices.

``dtype="bfloat16"`` runs the backbone, DSPP, decoder and both resizes in
bfloat16 (the parameters stay float32, BatchNorm normalises in float32,
see :mod:`.unet`); the head and the softmax run in float32. The image
mean is taken in float32 and rounded once; each resize rounds after each
of its two axes, as ``jax.image.resize`` on a bfloat16 array contracts
one axis at a time.

:func:`.unet.fold_batchnorm` (re-exported here) gives the BN-folded
module, as the JAX ``fold_deeplab_batchnorm_variables``: eps 1.001e-5 in
the backbone, 1e-3 in the blocks.

``DSPP_0/_ConvBlock_i`` of the Flax tree is ``dspp.blocks[i]`` here,
``_ConvBlock_i`` is ``blocks[i]``, ``Conv_0`` is ``head`` and ``resnet50``
keeps its Keras names. Modes as :class:`.unet.UNetModule`'s; there is no
dropout, so ``stats_mode`` is train mode and ``generator`` is unused.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import PerDevice, compute_dtype, resolve_device
from .base_model import BaseModel
from .resnet import ResNet50Backbone
from .unet import BatchNorm, ConvBlock, fold_batchnorm, stack_dtype  # noqa: F401 (re-exported)

DEEPLABV3PLUS_MODEL_NAME = "deeplabv3plus"
# Caffe-style ImageNet channel means, BGR (keras.applications.resnet50).
IMAGENET_MEANS_BGR = (103.939, 116.779, 123.68)
_MEANS = np.asarray(IMAGENET_MEANS_BGR, np.float32)
FEATURES = 256
LOW_FEATURES = 48
# flax he_normal: a normal truncated at +-2 standard deviations, rescaled
# by the truncated distribution's standard deviation.
_TRUNCATED_STD = 0.87962566103423978


def _block(cin: int, cout: int, kernel: int, use_bn: bool, dilation=1, bias=False):
    return ConvBlock(cin, cout, (kernel, kernel), use_bn, dilation=dilation, bias=bias)


def _interpolate(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def _resize_weights(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
    """``(n_out, n_in)``: the 1-D linear resize of ``F.interpolate``
    (half-pixel centres) as a matrix, in ``like``'s dtype and device."""
    dtype = torch.promote_types(like.dtype, torch.float32)
    eye = torch.eye(n_in, dtype=dtype, device=like.device)[:, None, :]
    weights = F.interpolate(eye, size=n_out, mode="linear", align_corners=False)
    return weights[:, 0, :].t().to(like.dtype)


class DeterministicResize(torch.autograd.Function):
    """``F.interpolate``'s bilinear resize of NCHW ``x`` to ``(h, w)``,
    whose backward is ``A_h^T @ g @ A_w`` with :func:`_resize_weights`'
    matrices: sums in a fixed order where PyTorch's CUDA backward adds
    with atomics. The forward is ``F.interpolate``'s, bit for bit."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        ctx.in_hw = (x.shape[2], x.shape[3])
        return _interpolate(x, h, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (ih, iw), (h, w) = ctx.in_hw, (g.shape[2], g.shape[3])
        if ih != h:
            g = _resize_weights(ih, h, g).t() @ g
        if iw != w:
            g = g @ _resize_weights(iw, w, g)
        return g, None, None


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.is_cuda and x.requires_grad and torch.are_deterministic_algorithms_enabled():
        return DeterministicResize.apply(x, h, w)
    return _interpolate(x, h, w)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW bilinear resize with half-pixel centres (``jax.image.resize``'s
    "bilinear" when it upsamples). Below float32 it resizes the width,
    rounds, then the height, as JAX's einsum contracts a bfloat16 array
    one axis at a time."""
    if x.dtype.itemsize >= 4:
        return _resize(x, h, w)
    return _resize(_resize(x, x.shape[2], w), h, w)


class DSPP(nn.Module):
    """Dilated Spatial Pyramid Pooling (NCHW)."""

    def __init__(self, in_features: int, use_bn: bool = True):
        super().__init__()
        self.blocks = nn.ModuleList(
            [_block(in_features, FEATURES, 1, use_bn, bias=True)]
            + [_block(in_features, FEATURES, 1, use_bn)]
            + [_block(in_features, FEATURES, 3, use_bn, dilation=d) for d in (6, 12, 18)]
            + [_block(5 * FEATURES, FEATURES, 1, use_bn)]
        )

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        mean = x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(2, 3), keepdim=True)
        pooled = self.blocks[0](mean.to(x.dtype), batch_stats)
        branches = [resize_bilinear(pooled, h, w)]
        branches += [block(x, batch_stats) for block in self.blocks[1:5]]
        return self.blocks[5](torch.cat(branches, dim=1), batch_stats)


class DeeplabV3PlusModule(nn.Module):
    def __init__(
        self, input_channels: int, num_classes: int, use_bn: bool = True, dtype="float32"
    ):
        super().__init__()
        self.compute_dtype = compute_dtype(dtype)
        self.hparams = dict(
            input_channels=input_channels, num_classes=num_classes, dtype=self.compute_dtype
        )
        self.use_bn = use_bn
        self.resnet50 = ResNet50Backbone(input_channels, use_bn)
        self.dspp = DSPP(FEATURES, use_bn)
        self.blocks = nn.ModuleList(
            [
                _block(64, LOW_FEATURES, 1, use_bn),
                _block(FEATURES + LOW_FEATURES, FEATURES, 3, use_bn),
                _block(FEATURES, FEATURES, 3, use_bn),
            ]
        )
        self.head = nn.Conv2d(FEATURES, num_classes, 1)
        self.eval()

    def forward(
        self,
        x: torch.Tensor,
        stats_mode: bool = False,
        generator: torch.Generator = None,
    ) -> torch.Tensor:
        """``(B, H, W, C)`` preprocessed input -> ``(B, H, W, classes)``
        float32 softmax probabilities; H and W divide by 4."""
        batch_stats = self.training or stats_mode
        h, w = x.shape[1], x.shape[2]
        x = x.to(stack_dtype(self)).permute(0, 3, 1, 2)
        tap, low = self.resnet50(x, batch_stats)
        y = resize_bilinear(self.dspp(tap, batch_stats), h // 4, w // 4)
        y = torch.cat([y, self.blocks[0](low, batch_stats)], dim=1)
        y = self.blocks[2](self.blocks[1](y, batch_stats), batch_stats)
        y = self.head(resize_bilinear(y, h, w).to(self.head.weight.dtype))
        return torch.softmax(y, dim=1).permute(0, 2, 3, 1)


def reset_parameters(module: DeeplabV3PlusModule, generator: torch.Generator) -> None:
    """The JAX module's init: He-normal (flax ``he_normal``) kernels in the
    DSPP and decoder blocks, glorot-uniform kernels in the backbone and the
    head, zero biases, BatchNorm scale 1 / bias 0 / mean 0 / var 1. Draws
    on the CPU from ``generator``, so a seed gives the same weights on
    every device."""
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, nn.Conv2d):
                out_ch, in_ch, kh, kw = m.weight.shape
                if name.startswith("resnet50.") or name == "head":
                    limit = math.sqrt(6.0 / (kh * kw * (in_ch + out_ch)))
                    m.weight.copy_((torch.rand(m.weight.shape, generator=generator) * 2 - 1) * limit)
                else:
                    std = math.sqrt(2.0 / (kh * kw * in_ch)) / _TRUNCATED_STD
                    w = torch.empty(m.weight.shape)
                    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                    m.weight.copy_(w * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


class DeeplabV3Plus(BaseModel):
    """Container with the reference's hyper-parameter surface."""

    def __init__(
        self,
        *,
        input_channels: int,
        num_classes: int,
        image_height: int,
        image_width: int,
        pretrained_weights: Optional[str] = None,
        dtype: str = "float32",
    ) -> None:
        super().__init__(
            input_channels=input_channels,
            num_classes=num_classes,
            image_height=image_height,
            image_width=image_width,
        )
        self.pretrained_weights = pretrained_weights
        self.dtype = dtype

    def get_config(self) -> dict:
        config = super().get_config()
        # Only when not the default, so that a default config stays the
        # reference's own ``DeepLabv3Plus(**config)`` surface.
        if str(self.dtype) != "float32":
            config["dtype"] = self.dtype
        if self.pretrained_weights is not None:
            config["pretrained_weights"] = self.pretrained_weights
        return config

    def get_preprocess_input_fn(self) -> Callable:
        means = PerDevice(_MEANS)

        def preprocess_input(x):
            """keras.applications.resnet50.preprocess_input (caffe mode):
            cast to float32, RGB -> BGR, subtract the float32 means. A
            tensor stays on its device; anything else becomes a numpy
            array."""
            if isinstance(x, torch.Tensor):
                x = x.to(torch.float32)
                return x.flip(-1) - means.on(x.device)
            return np.asarray(x, np.float32)[..., ::-1] - _MEANS

        return preprocess_input

    @property
    def spatial_divisor(self) -> int:
        # The decoder concatenates the DSPP output resized to (H//4, W//4)
        # with the stride-4 tap, which has ceil(H/4) rows.
        return 4

    def apply_pretrained_weights(self, state_dict: dict) -> dict:
        """Load the Keras-format ResNet50 ``.h5`` named by
        ``pretrained_weights`` into the backbone of ``state_dict`` (conv
        kernels, BN scales and offsets and moving statistics), leaving the
        DSPP, decoder and head as they are: the reference's
        ``weights="imagenet"`` backbone, from a local file."""
        if not self.pretrained_weights:
            return state_dict
        from pathlib import Path

        from ..common.model_io import (
            flax_from_state_dict,
            load_keras_resnet50_weights,
            state_dict_from_flax,
        )

        h5_path = Path(self.pretrained_weights)
        if not h5_path.exists():
            raise FileNotFoundError(
                f"pretrained_weights file not found: {h5_path} (the port "
                "loads Keras ResNet50 .h5 files locally; it downloads nothing)"
            )
        variables = flax_from_state_dict(state_dict)
        params, stats = load_keras_resnet50_weights(variables["params"]["resnet50"], h5_path)
        variables["params"]["resnet50"] = params
        stats_root = variables.setdefault("batch_stats", {}).setdefault("resnet50", {})
        for layer_name, layer_stats in stats.items():
            stats_root.setdefault(layer_name, {}).update(layer_stats)
        loaded = state_dict_from_flax(variables)
        return {
            k: loaded[k].to(device=v.device, dtype=v.dtype) for k, v in state_dict.items()
        }

    def build_model(
        self, generator: torch.Generator = None, device=None, use_bn: bool = True
    ) -> DeeplabV3PlusModule:
        """The DeepLabV3+ module in eval mode on ``device`` (None means
        CUDA), initialised from ``generator`` (a fresh unseeded one if
        None)."""
        device = resolve_device(device)
        module = DeeplabV3PlusModule(self.input_channels, self.num_classes, use_bn, self.dtype)
        reset_parameters(module, generator or torch.Generator())
        return module.to(device)
