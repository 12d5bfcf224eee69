"""Plain DeepLabV3+ (Chen et al., arXiv:1802.02611) on a Keras ResNet-50
backbone, as the benchmark's configuration states it: plain ``torch``
operations in float32 NCHW, nothing of the port.

- ResNet-50 v1 (He et al., arXiv:1512.03385) with Keras's layout: convs
  with a bias, BatchNorm eps 1.001e-5, the stride on the first 1x1 conv of
  a stage, a zero pad of 3 before the 7x7/2 stem and of 1 before the
  3x3/2 max-pool. It is tapped at ``conv4_block6_2_relu`` (stride 16)
  and ``conv2_block3_2_relu`` (stride 4); nothing after the first tap
  exists.
- Dilated spatial pyramid pooling: the image mean through a 1x1 block with
  a bias, resized back; a 1x1 block; 3x3 blocks at dilations 6, 12, 18;
  the five concatenated and projected by a 1x1 block. A block is conv
  (no bias unless stated) -> BatchNorm (eps 1e-3) -> ReLU.
- The decoder: a bilinear resize (half-pixel centres) to stride 4, the
  concat with a 48-channel 1x1 block of the low tap, two 3x3 blocks, a
  bilinear resize to the input size and a 1x1 head.

Input: uint8 RGB B-scans, Caffe preprocessing (RGB -> BGR, ImageNet
channel means subtracted). Parameter names and shapes are the served
module's ``state_dict``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .unet import batchnorm, same_pad

BACKBONE_EPS = 1.001e-5
STAGES = ((3, 64), (4, 128), (6, 256))
MEANS_BGR = (103.939, 116.779, 123.68)
FEATURES, LOW_FEATURES = 256, 48


def _backbone_convs(input_channels: int) -> list:
    """``(prefix, cin, cout, kernel, stride)`` of every backbone conv, and
    per block ``(prefix, first)`` in a second list."""
    convs = [("conv1", input_channels, 64, 7, 2)]
    blocks = []
    ch = 64
    for stage, (n, filters) in enumerate(STAGES, start=2):
        for b in range(1, n + 1):
            stride = 2 if b == 1 and stage > 2 else 1
            p = f"conv{stage}_block{b}"
            if b == 1:
                convs.append((f"{p}_0", ch, 4 * filters, 1, stride))
            convs.append((f"{p}_1", ch, filters, 1, stride))
            convs.append((f"{p}_2", filters, filters, 3, 1))
            if (stage, b) != (4, 6):
                convs.append((f"{p}_3", filters, 4 * filters, 1, 1))
            blocks.append((p, b == 1))
            ch = 4 * filters
    return convs, blocks


def head_blocks() -> list:
    """``(prefix, cin, cout, kernel, dilation, bias)`` of the DSPP and
    decoder blocks."""
    out = [("dspp.blocks.0", FEATURES, FEATURES, 1, 1, True), ("dspp.blocks.1", FEATURES, FEATURES, 1, 1, False)]
    out += [(f"dspp.blocks.{i}", FEATURES, FEATURES, 3, d, False) for i, d in ((2, 6), (3, 12), (4, 18))]
    out += [
        ("dspp.blocks.5", 5 * FEATURES, FEATURES, 1, 1, False),
        ("blocks.0", 64, LOW_FEATURES, 1, 1, False),
        ("blocks.1", FEATURES + LOW_FEATURES, FEATURES, 3, 1, False),
        ("blocks.2", FEATURES, FEATURES, 3, 1, False),
    ]
    return out


def _bn_spec(prefix: str, c: int) -> list:
    return [
        (f"{prefix}.weight", (c,), "bn_w"),
        (f"{prefix}.bias", (c,), "bn_b"),
        (f"{prefix}.running_mean", (c,), "bn_mean"),
        (f"{prefix}.running_var", (c,), "bn_var"),
    ]


def param_spec(cfg: dict) -> list:
    spec = []
    convs, _ = _backbone_convs(cfg["input_channels"])
    for p, cin, cout, k, _s in convs:
        spec += [
            (f"resnet50.{p}_conv.weight", (cout, cin, k, k), "conv_w"),
            (f"resnet50.{p}_conv.bias", (cout,), "conv_b"),
        ]
        spec += _bn_spec(f"resnet50.{p}_bn", cout)
    for p, cin, cout, k, _d, bias in head_blocks():
        spec.append((f"{p}.conv.weight", (cout, cin, k, k), "conv_w"))
        if bias:
            spec.append((f"{p}.conv.bias", (cout,), "conv_b"))
        spec += _bn_spec(f"{p}.bn", cout)
    spec += [
        ("head.weight", (cfg["num_classes"], FEATURES, 1, 1), "conv_w"),
        ("head.bias", (cfg["num_classes"],), "conv_b"),
    ]
    return spec


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB -> float32 BGR minus the ImageNet means."""
    means = torch.tensor(MEANS_BGR, dtype=torch.float32, device=images_u8.device)
    return images_u8.to(torch.float32).flip(-1) - means


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def logits(params: dict, x: torch.Tensor, cfg: dict, train: bool = False, keep=None, stats=None):
    """Preprocessed ``(B, H, W, 3)`` -> ``(B, classes, H, W)`` logits;
    ``train`` takes batch statistics, kept in ``stats`` where it is a dict
    (there is no dropout: ``keep`` is unused)."""
    h, w = x.shape[1], x.shape[2]
    convs, blocks = _backbone_convs(cfg["input_channels"])
    geometry = {p: (k, s) for p, _ci, _co, k, s in convs}

    def cbn(name, x):
        k, s = geometry[name]
        y = F.conv2d(x, params[f"resnet50.{name}_conv.weight"], params[f"resnet50.{name}_conv.bias"],
                     stride=s, padding=k // 2 if k == 3 else 0)
        return batchnorm(y, params, f"resnet50.{name}_bn", train, BACKBONE_EPS, stats)

    y = x.permute(0, 3, 1, 2)
    y = F.relu(cbn("conv1", F.pad(y, (3, 3, 3, 3))))
    y = F.max_pool2d(F.pad(y, (1, 1, 1, 1)), 3, 2)
    low = None
    for p, first in blocks:
        shortcut = cbn(f"{p}_0", y) if first else y
        z = F.relu(cbn(f"{p}_1", y))
        z = F.relu(cbn(f"{p}_2", z))
        if p == "conv2_block3":
            low = z
        if p == "conv4_block6":
            tap = z
            break
        y = F.relu(shortcut + cbn(f"{p}_3", z))

    def block(name, x, k, d=1):
        wt = params[f"{name}.conv.weight"]
        y = F.conv2d(same_pad(x, k, k, d), wt, params.get(f"{name}.conv.bias"), dilation=d)
        return F.relu(batchnorm(y, params, f"{name}.bn", train, stats=stats))

    th, tw = tap.shape[2], tap.shape[3]
    pooled = block("dspp.blocks.0", tap.mean(dim=(2, 3), keepdim=True), 1)
    branches = [_resize(pooled, th, tw), block("dspp.blocks.1", tap, 1)]
    branches += [block(f"dspp.blocks.{i}", tap, 3, d) for i, d in ((2, 6), (3, 12), (4, 18))]
    y = block("dspp.blocks.5", torch.cat(branches, dim=1), 1)
    y = torch.cat([_resize(y, h // 4, w // 4), block("blocks.0", low, 1)], dim=1)
    y = block("blocks.2", block("blocks.1", y, 3), 3)
    return F.conv2d(_resize(y, h, w), params["head.weight"], params["head.bias"])
