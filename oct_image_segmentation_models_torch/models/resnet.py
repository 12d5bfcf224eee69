"""Keras ResNet50 backbone in PyTorch, counterpart of the JAX package's
``models/resnet.py`` (the backbone of DeepLabV3+).

v1 bottleneck blocks with the stride on the first 1x1 conv, convs with a
bias, BatchNorm eps 1.001e-5 and momentum 0.99, and the Keras layer names
as submodule names (``conv1_conv``, ``conv2_block1_0_bn``, ...), so that
the weights bridge maps the Flax tree name for name.

The stem is a zero pad of 3, a 7x7/2 VALID conv, BN and ReLU, then a zero
pad of 1 and a 3x3/2 VALID max-pool. The pad is explicit, as in JAX:
``max_pool2d(padding=1)`` pads with -inf, which agrees only because the
ReLU output is >= 0.

The backbone stops at the ``conv4_block6_2_relu`` tap (stride 16, 256
channels), where DeepLabV3+'s functional model is pruned: the block's
``3_conv``/``3_bn`` tail and all of conv5 do not exist. ``forward`` returns
that tap and the ``conv2_block3_2_relu`` tap (stride 4, 64 channels), NCHW.

The backbone computes in its input's dtype. For a bfloat16 input that is
the Flax backbone with ``dtype=bfloat16`` as XLA compiles it: each conv
rounds its output to bfloat16 and adds its bias (:func:`.unet.conv2d`),
BatchNorm normalises that sum in float32 and rounds once, and the
residual add and ReLU run in bfloat16. The taps come back in bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .unet import BatchNorm, conv2d

BN_EPS = 1.001e-5
# (blocks, filters) per stage, Keras ResNet50 through conv4 only.
STAGES = ((3, 64), (4, 128), (6, 256))
LOW_TAP = "conv2_block3_2_relu"


class ResNet50Backbone(nn.Module):
    def __init__(self, input_channels: int = 3, use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        self.layers = []  # (block prefix, has a shortcut conv) in order
        self._pair("conv1", input_channels, 64, 7, stride=2, padding=0)
        ch = 64
        for stage, (blocks, filters) in enumerate(STAGES, start=2):
            for block in range(1, blocks + 1):
                stride = 2 if block == 1 and stage > 2 else 1
                prefix = f"conv{stage}_block{block}"
                if block == 1:
                    self._pair(f"{prefix}_0", ch, 4 * filters, 1, stride)
                self._pair(f"{prefix}_1", ch, filters, 1, stride)
                self._pair(f"{prefix}_2", filters, filters, 3, 1, padding=1)
                if (stage, block) != (len(STAGES) + 1, blocks):
                    self._pair(f"{prefix}_3", filters, 4 * filters, 1, 1)
                self.layers.append((prefix, block == 1))
                ch = 4 * filters

    def _pair(self, name, cin, cout, kernel, stride, padding=0):
        self.add_module(
            f"{name}_conv", nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding)
        )
        self.add_module(f"{name}_bn", BatchNorm(cout, BN_EPS) if self.use_bn else None)

    def _conv_bn(self, name, x, batch_stats, dtype):
        bn = getattr(self, f"{name}_bn")
        x = conv2d(getattr(self, f"{name}_conv"), x, dtype, bn_follows=bn is not None)
        return x if bn is None else bn(x, batch_stats).to(dtype)

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> tuple:
        """NCHW input -> ``(conv4_block6_2_relu, conv2_block3_2_relu)``, in
        the input's dtype."""
        dtype = x.dtype
        x = F.pad(x, (3, 3, 3, 3))
        x = F.relu(self._conv_bn("conv1", x, batch_stats, dtype)).to(dtype)
        x = F.pad(x, (1, 1, 1, 1))
        x = F.max_pool2d(x, 3, 2)
        low = None
        for prefix, first in self.layers:
            shortcut = self._conv_bn(f"{prefix}_0", x, batch_stats, dtype) if first else x
            y = F.relu(self._conv_bn(f"{prefix}_1", x, batch_stats, dtype))
            y = F.relu(self._conv_bn(f"{prefix}_2", y, batch_stats, dtype))
            if f"{prefix}_2_relu" == LOW_TAP:
                low = y
            if not hasattr(self, f"{prefix}_3_conv"):  # the pruned last block
                break
            x = F.relu(shortcut + self._conv_bn(f"{prefix}_3", y, batch_stats, dtype))
        return y, low
