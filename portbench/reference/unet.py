"""Plain U-Net (Ronneberger et al., arXiv:1505.04597) in the Keras layout
the benchmark's configuration names: ``pool_layers`` encoder levels of
``conv_layers`` x (3x3 "SAME" conv -> BatchNorm -> ReLU) and a 2x2 max-pool,
a bottleneck with Dropout(0.5), decoder levels of a nearest 2x upsample ->
2x2 "SAME" conv block -> skip concat -> ``conv_layers`` conv blocks, and a
1x1 head. Plain ``torch`` operations in float32 NCHW; nothing of the port.

Departures from the paper, as the configuration states them: "SAME"
padding (an even kernel pads one more row and column at the bottom and
right), BatchNorm with eps 1e-3 and Flax's batch statistics (biased
variance ``max(0, E[x^2] - E[x]^2)``), upsampling by repetition before a
2x2 conv in place of a transposed conv.

Parameters are a flat ``{name: tensor}`` dict whose names and shapes are
those of the served module's ``state_dict``, so that the benchmark hands
the same seeded weights to both sides.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
DROPOUT_RATE = 0.5


def block_shapes(cfg: dict) -> list:
    """``(in_channels, out_channels, kernel)`` of every conv block, in the
    order of the parameter names ``blocks.{i}``."""
    sn, pools, convs = cfg["start_neurons"], cfg["pool_layers"], cfg["conv_layers"]
    enc, dec = tuple(cfg["enc_kernel"]), tuple(cfg["dec_kernel"])
    out, ch, skips = [], cfg["input_channels"], []
    for level in range(pools):
        for _ in range(convs):
            out.append((ch, sn * 2**level, enc))
            ch = sn * 2**level
        skips.append(ch)
    for _ in range(convs):
        out.append((ch, sn * 2**pools, enc))
        ch = sn * 2**pools
    for level in reversed(range(pools)):
        out.append((ch, sn * 2**level, dec))
        ch = sn * 2**level + skips[level]
        for _ in range(convs):
            out.append((ch, sn * 2**level, enc))
            ch = sn * 2**level
    return out


def param_spec(cfg: dict) -> list:
    """``[(name, shape, kind)]``, kind one of ``conv_w``, ``conv_b``,
    ``bn_w``, ``bn_b``, ``bn_mean``, ``bn_var``."""
    spec = []
    for i, (cin, cout, (kh, kw)) in enumerate(block_shapes(cfg)):
        p = f"blocks.{i}"
        spec += [
            (f"{p}.conv.weight", (cout, cin, kh, kw), "conv_w"),
            (f"{p}.conv.bias", (cout,), "conv_b"),
            (f"{p}.bn.weight", (cout,), "bn_w"),
            (f"{p}.bn.bias", (cout,), "bn_b"),
            (f"{p}.bn.running_mean", (cout,), "bn_mean"),
            (f"{p}.bn.running_var", (cout,), "bn_var"),
        ]
    last = block_shapes(cfg)[-1][1]
    spec += [
        ("head.weight", (cfg["num_classes"], last, 1, 1), "conv_w"),
        ("head.bias", (cfg["num_classes"],), "conv_b"),
    ]
    return spec


def same_pad(x: torch.Tensor, kh: int, kw: int, dilation: int = 1) -> torch.Tensor:
    """XLA "SAME" padding at stride 1: the odd row and column go last."""
    eh, ew = (kh - 1) * dilation, (kw - 1) * dilation
    return F.pad(x, (ew // 2, ew - ew // 2, eh // 2, eh - eh // 2))


def batchnorm(x, params, prefix, train: bool, eps: float = BN_EPS, stats=None):
    """Eval: the running statistics. Train: the batch's, biased variance,
    also kept in ``stats[prefix]`` where ``stats`` is a dict."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        if stats is not None:
            stats[prefix] = (mean, var)
    else:
        mean, var = params[f"{prefix}.running_mean"], params[f"{prefix}.running_var"]
    scale = torch.rsqrt(var + eps) * params[f"{prefix}.weight"]
    return (x - mean[:, None, None]) * scale[:, None, None] + params[f"{prefix}.bias"][:, None, None]


def conv_block(x, params, prefix, kernel, train: bool, stats=None):
    x = F.conv2d(same_pad(x, *kernel), params[f"{prefix}.conv.weight"], params[f"{prefix}.conv.bias"])
    return F.relu(batchnorm(x, params, f"{prefix}.bn", train, stats=stats))


def logits(params: dict, x: torch.Tensor, cfg: dict, train: bool = False, keep=None, stats=None):
    """Preprocessed ``(B, H, W, C)`` float32 images -> ``(B, classes, H,
    W)`` logits. ``train`` takes batch statistics (kept in ``stats``) and
    applies ``keep``, the bottleneck's dropout keep-mask (NCHW bool), where
    it is given."""
    shapes = block_shapes(cfg)
    pools, convs = cfg["pool_layers"], cfg["conv_layers"]
    x = x.permute(0, 3, 1, 2)
    i, skips = 0, []

    def block(x):
        nonlocal i
        y = conv_block(x, params, f"blocks.{i}", shapes[i][2], train, stats)
        i += 1
        return y

    for _ in range(pools):
        for _ in range(convs):
            x = block(x)
        skips.append(x)
        x = F.max_pool2d(x, 2, 2)
    for _ in range(convs):
        x = block(x)
    if keep is not None:
        x = torch.where(keep, x / (1.0 - DROPOUT_RATE), torch.zeros_like(x))
    for level in reversed(range(pools)):
        x = block(F.interpolate(x, scale_factor=2, mode="nearest"))
        x = torch.cat([x, skips[level]], dim=1)
        for _ in range(convs):
            x = block(x)
    return F.conv2d(x, params["head.weight"], params["head.bias"])


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 B-scans -> x / 255 in float32."""
    return images_u8.to(torch.float32) / 255.0


def bottleneck_shape(cfg: dict, batch: int, h: int, w: int) -> tuple:
    """NCHW shape of the bottleneck, where the dropout mask is drawn."""
    f = 2 ** cfg["pool_layers"]
    return (batch, cfg["start_neurons"] * f, h // f, w // f)
