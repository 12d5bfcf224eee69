"""U-Net in PyTorch, counterpart of the JAX package's ``models/unet.py``.

Structure (op for op the JAX ``UNetModule``):
- ``pool_layers`` encoder levels of ``conv_layers`` x (Conv ``enc_kernel``
  -> BatchNorm -> ReLU) followed by a 2x2 VALID max-pool; filters
  ``start_neurons * 2**level``;
- bottleneck convs at ``start_neurons * 2**pool_layers`` + Dropout(0.5);
- decoder levels of nearest-neighbour 2x upsample -> Conv ``dec_kernel``
  -> BN -> ReLU -> skip concat -> ``conv_layers`` conv blocks;
- 1x1 Conv + softmax head in float32.

"SAME" padding of an even kernel puts the extra row and column at the
bottom/right, as XLA does. BatchNorm uses eps 1e-3 and the Flax formula
``(x - mean) * (rsqrt(var + eps) * scale) + bias``. ``ConvBlock_i`` of the
Flax tree is ``blocks[i]`` here, in the same creation order.

Modes, as the JAX module's ``training`` and ``stats_mode`` flags:
- ``module.eval()``: BatchNorm normalises with its running statistics and
  Dropout is off (inference);
- ``module.train()``: BatchNorm normalises with the batch statistics and
  updates its running statistics with momentum 0.99, Dropout is on;
- ``forward(x, stats_mode=True)`` in eval mode: batch statistics and the
  running update with Dropout off (the precise-BN collection forward of
  ``ops/bn_refresh.py``).

Batch statistics follow Flax 0.12: mean and ``var = max(0, E[x^2] -
E[x]^2)`` over (B, H, W), the biased variance; the running update is
``0.99 * running + 0.01 * batch`` for both. In an spmd train step over
several ranks the statistics are those of the global batch (the sums
all-reduced over the world, :func:`batch_moments`). ``nn.BatchNorm2d``
and ``nn.SyncBatchNorm`` are not used: their running variance is the
unbiased one and their momentum is the other way round. The dropout mask
comes from :func:`dropout_mask` and a ``torch.Generator`` on the
module's device.

The module's public layout is the JAX one: ``(B, H, W, C)`` input,
channels-last probabilities out. Inside, it runs NCHW.

``dtype="bfloat16"`` is the JAX module's ``dtype``, as XLA compiles it:
the parameters stay float32; the input is cast to bfloat16 and each conv
computes in it (:func:`conv2d`: weights and input cast, the conv's output
rounded to bfloat16, then the bias added, in float32 where BatchNorm
follows); BatchNorm takes its statistics and normalises in float32; each
block's output is rounded once to bfloat16; max-pool, dropout, upsample
and concat run in bfloat16; the 1x1 head and the softmax run in
float32. Gradients reach the float32
parameters through the casts.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import compute_dtype, resolve_device
from ..parallel import mesh as mesh_lib
from .base_model import BaseModel

UNET_MODEL_NAME = "unet"
BN_EPS = 1e-3
BN_MOMENTUM = 0.99
DROPOUT_RATE = 0.5


def _same_pads(kernel: Sequence[int]) -> tuple:
    """``F.pad`` amounts (left, right, top, bottom) of XLA "SAME" padding
    at stride 1: the odd row/column goes to the bottom/right."""
    kh, kw = kernel
    top, left = (kh - 1) // 2, (kw - 1) // 2
    return (left, kw - 1 - left, top, kh - 1 - top)


def dropout_mask(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Keep-mask of the bottleneck Dropout(0.5) for ``x`` (NCHW): True
    where a uniform draw from ``generator`` is below the keep probability,
    as ``jax.random.bernoulli`` keeps. The one place the mask is drawn; in
    an spmd step over several ranks it is this rank's rows of the global
    batch's mask (``parallel.mesh.draw_rows``)."""
    u = mesh_lib.draw_rows(
        lambda shape: torch.rand(
            shape, generator=generator, device=x.device, dtype=torch.float32
        ),
        x.shape,
    )
    return u < 1.0 - DROPOUT_RATE


def batch_moments(xs: torch.Tensor, dims: tuple, count: int) -> tuple:
    """Per-channel ``(E[x], E[x^2])`` of ``xs`` over ``dims``, ``count``
    elements a channel. In an spmd step over several ranks
    (``parallel.mesh.global_batch``) the sums and the count cover the
    world's global batch; elsewhere they are ``mean`` as it always was,
    so that one device stays bit for bit what it was."""
    if mesh_lib.global_mesh() is None:
        return xs.mean(dim=dims), (xs * xs).mean(dim=dims)
    sums = mesh_lib.all_reduce_sum(torch.stack([xs.sum(dim=dims), (xs * xs).sum(dim=dims)]))
    n = mesh_lib.global_batch_size(count)
    return sums[0] / n, sums[1] / n


def conv2d(
    conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype = None, bn_follows: bool = False
) -> torch.Tensor:
    """``conv(x)`` computing in ``dtype`` (None: ``x``'s). Below the
    weights' precision (a bfloat16 forward of float32 parameters) it is
    Flax's ``nn.Conv(dtype=)`` as XLA compiles it: ``x`` and the weights
    cast to ``dtype``, the conv's output rounded to it, then the bias (cast
    to ``dtype`` too) added and the sum rounded again. With ``bn_follows``
    the sum stays float32: where BatchNorm promotes it to float32, XLA
    drops the rounding between (``xla_allow_excess_precision``), and so
    does the port; BatchNorm's output is rounded by the caller."""
    dtype = x.dtype if dtype is None else dtype
    if dtype == conv.weight.dtype:
        return conv(x.to(dtype))
    y = conv._conv_forward(x.to(dtype), conv.weight.to(dtype), None)
    if conv.bias is None:
        return y
    bias = conv.bias.to(dtype)[:, None, None]
    if bn_follows:
        return y.to(conv.bias.dtype) + bias.to(conv.bias.dtype)
    return y + bias


class BatchNorm(nn.Module):
    """BatchNorm with the Flax formula, eps 1e-3 unless ``eps`` says
    otherwise (see the module docstring for the batch-statistics mode).
    The one BatchNorm of the port: DeepLabV3+'s backbone uses it with the
    Keras ResNet50's 1.001e-5. A bfloat16 input is promoted to float32 for
    the statistics and the normalisation (Flax's
    ``force_float32_reductions``), and the result rounded back once."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        if batch_stats:
            xs = x.to(torch.promote_types(x.dtype, self.running_mean.dtype))
            mean, mean2 = batch_moments(xs, (0, 2, 3), xs.numel() // xs.shape[1])
            # torch.maximum, not clamp: at var == 0 the gradient splits in
            # two as jnp.maximum's does.
            var = torch.maximum(mean2 - mean * mean, torch.zeros((), device=x.device))
            with torch.no_grad():
                self.running_mean.copy_(
                    BN_MOMENTUM * self.running_mean + (1 - BN_MOMENTUM) * mean
                )
                self.running_var.copy_(
                    BN_MOMENTUM * self.running_var + (1 - BN_MOMENTUM) * var
                )
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class ConvBlock(nn.Module):
    """"SAME" Conv -> BatchNorm -> ReLU. ``use_bn=False`` is the BN-folded
    inference variant (see :func:`fold_batchnorm_variables`). ``dilation``
    spreads the kernel's taps; ``bias=False`` drops the conv's bias (the
    folded variant always has one, to carry the folded shift); ``eps`` is
    the BatchNorm's."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: Sequence[int],
        use_bn: bool,
        dilation: int = 1,
        bias: bool = True,
        eps: float = BN_EPS,
    ):
        super().__init__()
        self.pads = _same_pads([(k - 1) * dilation + 1 for k in kernel])
        symmetric = self.pads[0] == self.pads[1] and self.pads[2] == self.pads[3]
        self.conv = nn.Conv2d(
            in_features,
            features,
            tuple(kernel),
            padding=(self.pads[2], self.pads[0]) if symmetric else 0,
            dilation=dilation,
            bias=bias or not use_bn,
        )
        self.needs_pad = not symmetric
        self.bn = BatchNorm(features, eps) if use_bn else None

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        """NCHW ``x`` -> the block's output in ``x``'s dtype (a bfloat16
        block rounds once, after BatchNorm and ReLU)."""
        dtype = x.dtype
        if self.needs_pad:
            x = F.pad(x, self.pads)
        x = conv2d(self.conv, x, bn_follows=self.bn is not None)
        if self.bn is not None:
            x = self.bn(x, batch_stats)
        return F.relu(x).to(dtype)


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
        dtype="float32",
    ):
        super().__init__()
        self.compute_dtype = compute_dtype(dtype)
        self.hparams = dict(
            input_channels=input_channels,
            num_classes=num_classes,
            start_neurons=start_neurons,
            pool_layers=pool_layers,
            conv_layers=conv_layers,
            enc_kernel=tuple(enc_kernel),
            dec_kernel=tuple(dec_kernel),
            dtype=self.compute_dtype,
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

    def forward(
        self,
        x: torch.Tensor,
        stats_mode: bool = False,
        generator: torch.Generator = None,
    ) -> torch.Tensor:
        """``(B, H, W, C)`` float input -> ``(B, H, W, classes)`` float32
        softmax probabilities. In train mode the dropout mask is drawn from
        ``generator`` (a generator on the input's device; None uses the
        device's default generator). The conv stack computes in the
        module's ``dtype`` when it is bfloat16, else in its parameters'
        dtype, float32 unless it was converted."""
        batch_stats = self.training or stats_mode
        x = x.to(stack_dtype(self)).permute(0, 3, 1, 2)
        blocks = iter(self.blocks)
        skips = []
        for _ in range(self.pool_layers):
            for _ in range(self.conv_layers):
                x = next(blocks)(x, batch_stats)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        for _ in range(self.conv_layers):
            x = next(blocks)(x, batch_stats)
        if self.training:
            keep = dropout_mask(x, generator)
            x = torch.where(keep, x / (1.0 - DROPOUT_RATE), x.new_zeros(()))
        for level in reversed(range(self.pool_layers)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = next(blocks)(x, batch_stats)
            x = torch.cat([x, skips[level]], dim=1)
            for _ in range(self.conv_layers):
                x = next(blocks)(x, batch_stats)
        x = self.head(x.to(self.head.weight.dtype))
        return torch.softmax(x, dim=1).permute(0, 2, 3, 1)


def stack_dtype(module: nn.Module) -> torch.dtype:
    """The dtype a module's conv stack computes in: bfloat16 for a
    bfloat16 module, else its parameters' dtype."""
    if module.compute_dtype == torch.bfloat16:
        return torch.bfloat16
    return module.head.weight.dtype


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
            dtype=self.dtype,
        )
        reset_parameters(module, generator or torch.Generator())
        return module.to(device)


def fold_conv_bn(state_dict: dict, conv: str, bn: str, eps: float) -> tuple:
    """``(kernel', bias')`` of the conv ``conv`` followed by the eval-mode
    BatchNorm ``bn`` (state_dict prefixes): ``kernel' = kernel *
    scale/sqrt(var+eps)`` per output channel and ``bias' = (bias - mean) *
    scale/sqrt(var+eps) + bn_bias``, a missing conv bias counting as 0, in
    the float32 operations of the JAX package's folds."""
    mean = state_dict[f"{bn}.running_mean"]
    var = state_dict[f"{bn}.running_var"]
    # torch's float32 CPU sqrt is not always correctly rounded; the
    # float64 root rounded to float32 is, as JAX's is.
    root = torch.sqrt((var + eps).to(torch.float64)).to(torch.float32)
    factor = state_dict[f"{bn}.weight"] / root
    bias = state_dict.get(f"{conv}.bias", 0.0)
    kernel = state_dict[f"{conv}.weight"] * factor[:, None, None, None]
    return kernel, (bias - mean) * factor + state_dict[f"{bn}.bias"]


def fold_batchnorm_variables(state_dict: dict, eps: dict = None) -> dict:
    """Fold inference BatchNorm into the preceding conv weights
    (:func:`fold_conv_bn`), as the JAX ``fold_batchnorm_variables``.
    ``eps`` maps each BatchNorm's prefix to its eps; None means every
    ``{p}.bn`` of a :class:`UNetModule` ``state_dict`` with ``BN_EPS``. The
    BatchNorm ``{p}bn`` folds into the conv ``{p}conv`` (``{p}.bn`` into
    ``{p}.conv``, the ResNet50's ``{p}_bn`` into ``{p}_conv``). Returns the
    ``state_dict`` of the model built with ``use_bn=False``.
    """
    if eps is None:
        eps = {k[: -len(".weight")]: BN_EPS for k in state_dict if k.endswith(".bn.weight")}
    folded = {k: v for k, v in state_dict.items() if k.rsplit(".", 1)[0] not in eps}
    for bn, bn_eps in eps.items():
        conv = bn[: -len("bn")] + "conv"
        folded[f"{conv}.weight"], folded[f"{conv}.bias"] = fold_conv_bn(
            state_dict, conv, bn, bn_eps
        )
    return folded


def fold_batchnorm(module: nn.Module, dtype=None) -> nn.Module:
    """A BN-folded copy (``use_bn=False``) of ``module``, a
    :class:`UNetModule` or a DeepLabV3+, on its device, computing in
    ``dtype`` (None: the module's own): every :class:`BatchNorm` folds into
    the conv before it with its own eps (:func:`fold_batchnorm_variables`).
    The folded weights stay float32; a bfloat16 forward casts them, as
    JAX's ``jnp.asarray(w, dtype)``."""
    dtype = module.compute_dtype if dtype is None else compute_dtype(dtype)
    if not module.use_bn and dtype == module.compute_dtype:
        return module
    eps = {name: m.eps for name, m in module.named_modules() if isinstance(m, BatchNorm)}
    folded_state = fold_batchnorm_variables(module.state_dict(), eps)
    folded = type(module)(**{**module.hparams, "dtype": dtype}, use_bn=False)
    folded.load_state_dict(folded_state)
    return folded.to(next(module.parameters()).device)
