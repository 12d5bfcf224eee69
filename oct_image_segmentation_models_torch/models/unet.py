"""U-Net in PyTorch, counterpart of the JAX package's ``models/unet.py``.

Structure (op for op the JAX ``UNetModule``):
- ``pool_layers`` encoder levels of ``conv_layers`` x (Conv ``enc_kernel``
  -> BatchNorm -> ReLU) followed by a 2x2 VALID max-pool; filters
  ``start_neurons * 2**level``;
- bottleneck convs at ``start_neurons * 2**pool_layers`` (its Dropout(0.5)
  is the identity at inference);
- decoder levels of nearest-neighbour 2x upsample -> Conv ``dec_kernel``
  -> BN -> ReLU -> skip concat -> ``conv_layers`` conv blocks;
- 1x1 Conv + softmax head in float32.

"SAME" padding of an even kernel puts the extra row and column at the
bottom/right, as XLA does. BatchNorm uses eps 1e-3 and the Flax formula
``(x - mean) * (rsqrt(var + eps) * scale) + bias``. ``ConvBlock_i`` of the
Flax tree is ``blocks[i]`` here, in the same creation order.

The module's public layout is the JAX one: ``(B, H, W, C)`` input,
channels-last probabilities out. Inside, it runs NCHW. Only inference is
ported; training is ROADMAP A8.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .base_model import BaseModel

UNET_MODEL_NAME = "unet"
BN_EPS = 1e-3


def _same_pads(kernel: Sequence[int]) -> tuple:
    """``F.pad`` amounts (left, right, top, bottom) of XLA "SAME" padding
    at stride 1: the odd row/column goes to the bottom/right."""
    kh, kw = kernel
    top, left = (kh - 1) // 2, (kw - 1) // 2
    return (left, kw - 1 - left, top, kh - 1 - top)


class BatchNorm(nn.Module):
    """Inference BatchNorm with the Flax formula and eps 1e-3.

    Keras momentum 0.99 (torch momentum 0.01) matters only to training,
    which is not ported yet."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x - self.running_mean[:, None, None]) * mul[:, None, None]
        return y + self.bias[:, None, None]


class ConvBlock(nn.Module):
    """Conv -> BatchNorm -> ReLU. ``use_bn=False`` is the BN-folded
    inference variant (see :func:`fold_batchnorm_variables`)."""

    def __init__(
        self, in_features: int, features: int, kernel: Sequence[int], use_bn: bool
    ):
        super().__init__()
        self.pads = _same_pads(kernel)
        symmetric = self.pads[0] == self.pads[1] and self.pads[2] == self.pads[3]
        self.conv = nn.Conv2d(
            in_features,
            features,
            tuple(kernel),
            padding=(self.pads[2], self.pads[0]) if symmetric else 0,
        )
        self.needs_pad = not symmetric
        self.bn = BatchNorm(features) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.needs_pad:
            x = F.pad(x, self.pads)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x)


class UNetModule(nn.Module):
    def __init__(
        self,
        input_channels: int,
        num_classes: int,
        start_neurons: int = 8,
        pool_layers: int = 4,
        conv_layers: int = 2,
        enc_kernel: Sequence[int] = (3, 3),
        dec_kernel: Sequence[int] = (2, 2),
        use_bn: bool = True,
    ):
        super().__init__()
        self.hparams = dict(
            input_channels=input_channels,
            num_classes=num_classes,
            start_neurons=start_neurons,
            pool_layers=pool_layers,
            conv_layers=conv_layers,
            enc_kernel=tuple(enc_kernel),
            dec_kernel=tuple(dec_kernel),
        )
        self.pool_layers = pool_layers
        self.conv_layers = conv_layers
        self.use_bn = use_bn
        blocks = []
        ch = input_channels
        skip_ch = []
        for level in range(pool_layers):
            feats = start_neurons * 2**level
            for _ in range(conv_layers):
                blocks.append(ConvBlock(ch, feats, enc_kernel, use_bn))
                ch = feats
            skip_ch.append(ch)
        feats = start_neurons * 2**pool_layers
        for _ in range(conv_layers):
            blocks.append(ConvBlock(ch, feats, enc_kernel, use_bn))
            ch = feats
        for level in reversed(range(pool_layers)):
            feats = start_neurons * 2**level
            blocks.append(ConvBlock(ch, feats, dec_kernel, use_bn))
            ch = feats + skip_ch[level]
            for _ in range(conv_layers):
                blocks.append(ConvBlock(ch, feats, enc_kernel, use_bn))
                ch = feats
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Conv2d(ch, num_classes, 1)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, C)`` float input -> ``(B, H, W, classes)`` float32
        softmax probabilities."""
        if self.training:
            raise NotImplementedError(
                "the PyTorch U-Net runs inference only; training is ROADMAP A8"
            )
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        blocks = iter(self.blocks)
        skips = []
        for _ in range(self.pool_layers):
            for _ in range(self.conv_layers):
                x = next(blocks)(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        for _ in range(self.conv_layers):
            x = next(blocks)(x)
        for level in reversed(range(self.pool_layers)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = next(blocks)(x)
            x = torch.cat([x, skips[level]], dim=1)
            for _ in range(self.conv_layers):
                x = next(blocks)(x)
        x = self.head(x)
        return torch.softmax(x, dim=1).permute(0, 2, 3, 1)


def reset_parameters(module: UNetModule, generator: torch.Generator) -> None:
    """Keras-default init: glorot-uniform conv kernels, zero biases, BN
    scale 1 / bias 0 / mean 0 / var 1. Draws on the CPU from ``generator``
    so a seed gives the same weights on every device."""
    with torch.no_grad():
        for conv in [b.conv for b in module.blocks] + [module.head]:
            out_ch, in_ch, kh, kw = conv.weight.shape
            limit = math.sqrt(6.0 / (kh * kw * (in_ch + out_ch)))
            w = torch.rand(conv.weight.shape, generator=generator) * 2 - 1
            conv.weight.copy_(w * limit)
            conv.bias.zero_()
        for block in module.blocks:
            if block.bn is not None:
                block.bn.weight.fill_(1.0)
                block.bn.bias.zero_()
                block.bn.running_mean.zero_()
                block.bn.running_var.fill_(1.0)


class UNet(BaseModel):
    """Container with the reference's hyper-parameter surface."""

    def __init__(
        self,
        *,
        input_channels: int,
        num_classes: int,
        image_height: int,
        image_width: int,
        start_neurons: int = 8,
        pool_layers: int = 4,
        conv_layers: int = 2,
        enc_kernel=(3, 3),
        dec_kernel=(2, 2),
        dtype: str = "float32",
    ) -> None:
        super().__init__(
            input_channels=input_channels,
            num_classes=num_classes,
            image_height=image_height,
            image_width=image_width,
        )
        self.start_neurons = start_neurons
        self.pool_layers = pool_layers
        self.conv_layers = conv_layers
        self.enc_kernel = tuple(enc_kernel)
        self.dec_kernel = tuple(dec_kernel)
        self.dtype = dtype

    def get_preprocess_input_fn(self) -> Callable:
        def preprocess_input_inner(x):
            return x / 255.0

        return preprocess_input_inner

    @property
    def spatial_divisor(self) -> int:
        return 2**self.pool_layers

    def get_config(self) -> dict:
        config = super().get_config()
        config.update(
            {
                "start_neurons": self.start_neurons,
                "pool_layers": self.pool_layers,
                "conv_layers": self.conv_layers,
                "enc_kernel": self.enc_kernel,
                "dec_kernel": self.dec_kernel,
            }
        )
        if str(self.dtype) != "float32":
            config["dtype"] = self.dtype
        return config

    def build_model(
        self, generator: torch.Generator = None, device=None, use_bn: bool = True
    ) -> UNetModule:
        """The U-Net module in eval mode on ``device`` (None means CUDA),
        initialised from ``generator`` (a fresh unseeded one if None)."""
        if str(self.dtype) != "float32":
            raise NotImplementedError(
                f"dtype={self.dtype!r}: the PyTorch U-Net runs float32 only"
            )
        device = resolve_device(device)
        module = UNetModule(
            input_channels=self.input_channels,
            num_classes=self.num_classes,
            start_neurons=self.start_neurons,
            pool_layers=self.pool_layers,
            conv_layers=self.conv_layers,
            enc_kernel=self.enc_kernel,
            dec_kernel=self.dec_kernel,
            use_bn=use_bn,
        )
        reset_parameters(module, generator or torch.Generator())
        return module.to(device)


def fold_batchnorm_variables(state_dict: dict) -> dict:
    """Fold inference BatchNorm into the preceding conv weights.

    ``kernel' = kernel * scale/sqrt(var+eps)`` per output channel and
    ``bias' = (bias - mean) * scale/sqrt(var+eps) + bn_bias``, in the same
    float32 operations as the JAX ``fold_batchnorm_variables``. Takes a
    :class:`UNetModule` ``state_dict`` and returns one for
    ``UNetModule(use_bn=False)``.
    """
    folded = {k: v for k, v in state_dict.items() if ".bn." not in k}
    for key in state_dict:
        if not key.endswith(".bn.weight"):
            continue
        block = key[: -len(".bn.weight")]
        mean = state_dict[f"{block}.bn.running_mean"]
        var = state_dict[f"{block}.bn.running_var"]
        # torch's float32 CPU sqrt is not always correctly rounded; the
        # float64 root rounded to float32 is, as JAX's is.
        root = torch.sqrt((var + BN_EPS).to(torch.float64)).to(torch.float32)
        factor = state_dict[f"{block}.bn.weight"] / root
        kernel = state_dict[f"{block}.conv.weight"]
        bias = state_dict[f"{block}.conv.bias"]
        folded[f"{block}.conv.weight"] = kernel * factor[:, None, None, None]
        folded[f"{block}.conv.bias"] = (
            (bias - mean) * factor + state_dict[f"{block}.bn.bias"]
        )
    return folded


def fold_batchnorm(module: UNetModule) -> UNetModule:
    """A BN-folded copy of ``module`` (``use_bn=False``) on its device."""
    if not module.use_bn:
        return module
    folded = UNetModule(**module.hparams, use_bn=False)
    folded.load_state_dict(fold_batchnorm_variables(module.state_dict()))
    return folded.to(module.head.weight.device)
