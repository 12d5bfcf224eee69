"""TransUNet in PyTorch: the hybrid R50-ViT-B/16 encoder and the cascaded
upsampler of Chen et al., "TransUNet: Transformers Make Strong Encoders for
Medical Image Segmentation" (arXiv:2102.04306; github.com/Beckschen/TransUNet,
``networks/vit_seg_modeling.py``, ``networks/vit_seg_modeling_resnet_skip.py``,
widths from ``networks/vit_seg_configs.py::get_r50_b16_config``). The JAX
package has no counterpart.

Structure, at the defaults (the published widths):

- hybrid stem, a ResNetV2 of ``resnet_units`` (3, 4, 9) bottleneck units at
  width ``resnet_width`` (64). Every conv is a weight-standardised
  :class:`StdConv2d` without bias. The root is a 7x7/2 conv (pad 3),
  GroupNorm(32, eps 1e-6) and ReLU: skip 3, at 1/2. A 3x3/2 max-pool with
  no padding follows. A unit is 1x1 conv, GN, ReLU; 3x3 conv with the
  unit's stride (pad 1), GN, ReLU; 1x1 conv to 4x the unit's width, GN;
  the residual added, ReLU. Where the stride or the width changes the
  residual is a strided 1x1 conv and a per-channel GroupNorm (eps 1e-5).
  Stage 1 (stride 1) gives skip 2 at 1/4, stage 2 (stride 2) skip 1 at
  1/8, stage 3 (stride 2) the 1/16 map;
- embedding: a 1x1 conv with bias to ``hidden`` (768), flattened to
  (H/16)(W/16) tokens, plus a position embedding;
- encoder: ``layers`` (12) pre-norm blocks, ``x += out(softmax(q k^T /
  sqrt(d)) v)`` over LayerNorm(x) with ``heads`` (12) heads of ``hidden /
  heads``, then ``x += fc2(GELU(fc1(LayerNorm(x))))`` with ``mlp`` (3072)
  and the exact (erf) GELU; LayerNorm eps 1e-6, a final LayerNorm;
- decoder (CUP): the tokens as a ``hidden`` x H/16 x W/16 map, a 3x3
  conv-BN-ReLU to 512 (``conv_more``), then per width of
  ``decoder_channels`` (256, 128, 64, 16) a bilinear x2 upsample with
  aligned corners (``nn.UpsamplingBilinear2d``), the concat of skips 1, 2,
  3 for the first ``n_skip`` blocks, and two 3x3 conv-BN-ReLU blocks
  (:class:`.unet.ConvBlock`, no conv bias, BatchNorm eps 1e-5);
- a 3x3 head with bias and softmax.

Written-down departures from the published code:

- (a) per-axis skip padding: the published ResNetV2 zero-pads the stride-4
  skip to a square ``in_size / 4`` and reshapes the tokens to a square
  grid; here the skips are padded at the bottom and right to (H/4, W/4)
  and (H/8, W/8) and the grid is (H/16, W/16): at 512x1024 stage 1's
  127x255 becomes 128x256;
- (b) the position embedding is a parameter at this image size's grid
  (the published one is learned at 14x14 and resized on loading);
- (c) the input is the grey B-scan over 3 channels, preprocessed ``x /
  255``, as TransUNet repeats a one-channel image;
- (d) no dropout: the attention's and the MLP's dropout are left out,
  also in train mode;
- (e) ``num_classes`` outputs with a softmax on the head, as the package's
  models return probabilities.

``build_model`` draws a seeded initialisation, not the published
ImageNet-21k weights. Attention runs through
``F.scaled_dot_product_attention``: in float32 on an H100 that is
PyTorch's memory-efficient kernel (its 3xTF32 tensor-core products keep
float32 accuracy), since the flash and cuDNN kernels take no float32.

:func:`fold_transunet` is the inference variant (``use_bn=False``): every
StdConv weight standardised once and every decoder BatchNorm folded into
its conv (:func:`.unet.fold_batchnorm_variables`); GroupNorm and
LayerNorm stay. Only float32 is served: there is no bfloat16 path.

Modes as :class:`.unet.UNetModule`'s: the decoder's BatchNorms take batch
statistics in train mode or with ``stats_mode``; ``generator`` is unused.
Under a profiler the forward records the spans ``transunet.hybrid``,
``transunet.encoder`` (counts ``tokens``, the batch's B*N, and
``layers``) and ``transunet.decoder`` (:mod:`..common.profiling`).

Every module list is named ``blocks``, so that the weights bridge of
:mod:`..common.model_io` keeps its indices.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..common import profiling
from .base_model import BaseModel
from .unet import BatchNorm, ConvBlock, fold_batchnorm_variables

TRANSUNET_MODEL_NAME = "transunet"
STD_EPS = 1e-5
GN_EPS = 1e-6
PROJ_GN_EPS = 1e-5
LN_EPS = 1e-6
DECODER_BN_EPS = 1e-5
HEAD_CHANNELS = 512
GROUPS = 32
PATCH = 16  # the encoder's grid step: the ResNet's stride


def standardize(weight: torch.Tensor) -> torch.Tensor:
    """``(w - mean) / sqrt(var + 1e-5)`` per output channel, the biased
    variance over (in, kh, kw)."""
    var, mean = torch.var_mean(weight, dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (weight - mean) / torch.sqrt(var + STD_EPS)


class StdConv2d(nn.Conv2d):
    """A conv without bias whose weight is standardised in every forward
    (:func:`standardize`), or, with ``standardized=True``, holds the
    standardised weight already (the folded module)."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, standardized=False):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.standardized = standardized

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight if self.standardized else standardize(self.weight)
        return self._conv_forward(x, weight, None)


class Bottleneck(nn.Module):
    """The published ``PreActBottleneck`` (which is post-activation)."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int, standardized: bool):
        super().__init__()
        self.conv1 = StdConv2d(cin, cmid, 1, standardized=standardized)
        self.gn1 = nn.GroupNorm(GROUPS, cmid, eps=GN_EPS)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride, 1, standardized=standardized)
        self.gn2 = nn.GroupNorm(GROUPS, cmid, eps=GN_EPS)
        self.conv3 = StdConv2d(cmid, cout, 1, standardized=standardized)
        self.gn3 = nn.GroupNorm(GROUPS, cout, eps=GN_EPS)
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride, standardized=standardized)
            self.gn_proj = nn.GroupNorm(cout, cout, eps=PROJ_GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.gn_proj(self.downsample(x)) if hasattr(self, "downsample") else x
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        return F.relu(residual + self.gn3(self.conv3(y)))


def _pad_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``x`` zero-padded at the bottom and right to ``h`` x ``w`` (at most
    2 rows and columns, as the published code asserts)."""
    dh, dw = h - x.shape[2], w - x.shape[3]
    if not (0 <= dh < 3 and 0 <= dw < 3):
        raise ValueError(f"skip of {tuple(x.shape[2:])} cannot be padded to {(h, w)}")
    return F.pad(x, (0, dw, 0, dh)) if dh or dw else x


class HybridResNet(nn.Module):
    """The ResNetV2 stem: ``forward(x) -> (1/16 map, [skip 1/8, skip 1/4,
    skip 1/2])``; the units of all stages in one list."""

    def __init__(self, cin: int, units: Sequence[int], width: int, standardized: bool):
        super().__init__()
        self.units = tuple(units)
        self.root = StdConv2d(cin, width, 7, 2, 3, standardized=standardized)
        self.root_gn = nn.GroupNorm(GROUPS, width, eps=GN_EPS)
        blocks, ch = [], width
        for stage, n in enumerate(self.units):
            mid = width * 2**stage
            for u in range(n):
                stride = 2 if stage > 0 and u == 0 else 1
                blocks.append(Bottleneck(ch, 4 * mid, mid, stride, standardized))
                ch = 4 * mid
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = ch

    def forward(self, x: torch.Tensor):
        h, w = x.shape[2], x.shape[3]
        y = F.relu(self.root_gn(self.root(x)))
        skips = [y]
        y = F.max_pool2d(y, 3, 2)
        blocks = iter(self.blocks)
        for stage, n in enumerate(self.units):
            for _ in range(n):
                y = next(blocks)(y)
            if stage < len(self.units) - 1:
                div = 4 * 2**stage
                skips.append(_pad_to(y, h // div, w // div))
        return y, skips[::-1]


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape

        def split(t):
            return t.view(b, n, self.heads, c // self.heads).transpose(1, 2)

        ctx = F.scaled_dot_product_attention(split(self.query(x)), split(self.key(x)), split(self.value(x)))
        return self.out(ctx.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp)
        self.fc2 = nn.Linear(mlp, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class EncoderBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp: int):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.attn = Attention(hidden, heads)
        self.ffn_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.ffn = Mlp(hidden, mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Embedding(nn.Module):
    def __init__(self, cin: int, hidden: int, tokens: int):
        super().__init__()
        self.patch = nn.Conv2d(cin, hidden, 1)
        self.position = nn.Parameter(torch.zeros(1, tokens, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.patch(x).flatten(2).transpose(1, 2) + self.position


class Encoder(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int, mlp: int):
        super().__init__()
        self.blocks = nn.ModuleList([EncoderBlock(hidden, heads, mlp) for _ in range(layers)])
        self.encoder_norm = nn.LayerNorm(hidden, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return self.encoder_norm(x)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """``nn.UpsamplingBilinear2d(scale_factor=2)``."""
    return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear", align_corners=True)


def decoder_widths(hidden: int, decoder_channels: Sequence[int], skip_channels: Sequence[int], n_skip: int):
    """``[(cin, cout)]`` of ``conv_more`` and then the two convs of each
    decoder block, with the skips' widths added to the first."""
    skips = [c if i < n_skip else 0 for i, c in enumerate(skip_channels)]
    ins = [HEAD_CHANNELS] + list(decoder_channels[:-1])
    out = [(hidden, HEAD_CHANNELS)]
    for cin, skip, cout in zip(ins, skips, decoder_channels):
        out += [(cin + skip, cout), (cout, cout)]
    return out


class Decoder(nn.Module):
    def __init__(self, widths, n_skip: int, use_bn: bool):
        super().__init__()
        self.n_skip = n_skip

        def block(cin, cout):
            return ConvBlock(cin, cout, (3, 3), use_bn, bias=False, eps=DECODER_BN_EPS)

        self.conv_more = block(*widths[0])
        self.blocks = nn.ModuleList([block(*w) for w in widths[1:]])

    def forward(self, x: torch.Tensor, skips: list, batch_stats: bool) -> torch.Tensor:
        x = self.conv_more(x, batch_stats)
        for i in range(len(self.blocks) // 2):
            x = _up2(x)
            if i < self.n_skip:
                x = torch.cat([x, skips[i]], dim=1)
            x = self.blocks[2 * i](x, batch_stats)
            x = self.blocks[2 * i + 1](x, batch_stats)
        return x


class TransUNetModule(nn.Module):
    def __init__(
        self,
        input_channels: int,
        num_classes: int,
        image_height: int,
        image_width: int,
        hidden: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp: int = 3072,
        resnet_units: Sequence[int] = (3, 4, 9),
        resnet_width: int = 64,
        decoder_channels: Sequence[int] = (256, 128, 64, 16),
        n_skip: int = 3,
        use_bn: bool = True,
    ):
        super().__init__()
        if image_height % PATCH or image_width % PATCH:
            raise ValueError(f"TransUNet needs H and W divisible by {PATCH}, got {image_height}x{image_width}")
        if hidden % heads:
            raise ValueError(f"hidden {hidden} does not split into {heads} heads")
        self.compute_dtype = torch.float32
        self.hparams = dict(
            input_channels=input_channels, num_classes=num_classes, image_height=image_height,
            image_width=image_width, hidden=hidden, layers=layers, heads=heads, mlp=mlp,
            resnet_units=tuple(resnet_units), resnet_width=resnet_width,
            decoder_channels=tuple(decoder_channels), n_skip=n_skip,
        )
        self.use_bn = use_bn
        standardized = not use_bn
        self.hybrid = HybridResNet(input_channels, resnet_units, resnet_width, standardized)
        tokens = (image_height // PATCH) * (image_width // PATCH)
        self.embed = Embedding(self.hybrid.out_channels, hidden, tokens)
        self.encoder = Encoder(hidden, layers, heads, mlp)
        # Skips 1, 2, 3: stage 2's and stage 1's outputs, the root's.
        skip_channels = [4 * resnet_width * 2 ** s for s in reversed(range(len(resnet_units) - 1))]
        skip_channels = (skip_channels + [resnet_width, 0])[: len(decoder_channels)]
        self.decoder = Decoder(decoder_widths(hidden, decoder_channels, skip_channels, n_skip), n_skip, use_bn)
        self.head = nn.Conv2d(decoder_channels[-1], num_classes, 3, padding=1)
        self.eval()

    def forward(
        self,
        x: torch.Tensor,
        stats_mode: bool = False,
        generator: torch.Generator = None,
    ) -> torch.Tensor:
        """``(B, H, W, C)`` preprocessed input -> ``(B, H, W, classes)``
        float32 softmax probabilities."""
        batch_stats = self.training or stats_mode
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        gh, gw = h // PATCH, w // PATCH
        with profiling.span("transunet.hybrid"):
            y, skips = self.hybrid(x.permute(0, 3, 1, 2))
        with profiling.span("transunet.encoder", tokens=b * gh * gw, layers=len(self.encoder.blocks)):
            tokens = self.encoder(self.embed(y))
        with profiling.span("transunet.decoder"):
            y = tokens.transpose(1, 2).reshape(b, -1, gh, gw)
            y = self.head(self.decoder(y, skips, batch_stats))
            return torch.softmax(y, dim=1).permute(0, 2, 3, 1)


def reset_parameters(module: TransUNetModule, generator: torch.Generator) -> None:
    """A seeded initialisation, drawn on the CPU from ``generator`` so that
    a seed gives the same weights on every device: conv and linear kernels
    He-normal on the fan-in, zero biases, norm scales 1 and shifts 0, the
    position embedding N(0, 0.02^2), BatchNorm mean 0 / var 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
        module.embed.position.copy_(0.02 * torch.randn(module.embed.position.shape, generator=generator))


def fold_transunet(module: TransUNetModule) -> TransUNetModule:
    """The inference copy (``use_bn=False``) of ``module`` on its device:
    StdConv weights standardised once, decoder BatchNorms folded into
    their convs."""
    if not module.use_bn:
        return module
    eps = {name: m.eps for name, m in module.named_modules() if isinstance(m, BatchNorm)}
    state = fold_batchnorm_variables(module.state_dict(), eps)
    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, StdConv2d):
                state[f"{name}.weight"] = standardize(m.weight)
    folded = TransUNetModule(**module.hparams, use_bn=False)
    folded.load_state_dict(state)
    return folded.to(next(module.parameters()).device)


class TransUNet(BaseModel):
    """Container of TransUNet's hyper-parameters (defaults: R50-ViT-B/16)."""

    def __init__(
        self,
        *,
        input_channels: int,
        num_classes: int,
        image_height: int,
        image_width: int,
        hidden: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp: int = 3072,
        resnet_units: Sequence[int] = (3, 4, 9),
        resnet_width: int = 64,
        decoder_channels: Sequence[int] = (256, 128, 64, 16),
        n_skip: int = 3,
    ) -> None:
        super().__init__(
            input_channels=input_channels,
            num_classes=num_classes,
            image_height=image_height,
            image_width=image_width,
        )
        self.arch = dict(
            hidden=hidden, layers=layers, heads=heads, mlp=mlp, resnet_units=list(resnet_units),
            resnet_width=resnet_width, decoder_channels=list(decoder_channels), n_skip=n_skip,
        )

    def get_config(self) -> dict:
        return {**super().get_config(), **self.arch}

    def get_preprocess_input_fn(self) -> Callable:
        def preprocess_input(x):
            return x / 255.0

        return preprocess_input

    @property
    def spatial_divisor(self) -> int:
        return PATCH

    def build_model(
        self, generator: torch.Generator = None, device=None, use_bn: bool = True
    ) -> TransUNetModule:
        """The module in eval mode on ``device`` (None means CUDA),
        initialised from ``generator`` (a fresh unseeded one if None);
        ``use_bn=False`` builds the folded layout, to load a folded
        state_dict into."""
        device = resolve_device(device)
        module = TransUNetModule(**self.get_config(), use_bn=use_bn)
        reset_parameters(module, generator or torch.Generator())
        return module.to(device)
