"""Plain TransUNet, R50-ViT-B/16 (Chen et al., arXiv:2102.04306;
github.com/Beckschen/TransUNet, ``networks/vit_seg_modeling.py`` and
``networks/vit_seg_modeling_resnet_skip.py``, widths from
``networks/vit_seg_configs.py::get_r50_b16_config``), as the benchmark's
configuration states it: plain ``torch`` operations in float32 NCHW, the
attention written out as ``softmax(q k^T / sqrt(d)) v``, nothing of the
port.

- Hybrid stem, ResNetV2 of ``resnet_units`` bottleneck units at width
  ``resnet_width``: every conv weight-standardised per output channel,
  ``(w - mean) / sqrt(var + 1e-5)`` with the biased variance, no bias. Root
  7x7/2 (pad 3), GroupNorm(32, eps 1e-6), ReLU (skip 3); a 3x3/2 max-pool
  with no padding; per unit 1x1, GN, ReLU, 3x3 with the unit's stride (pad
  1), GN, ReLU, 1x1 to 4x width, GN, the residual (a strided 1x1 and a
  per-channel GroupNorm, eps 1e-5, where stride or width change), ReLU.
  Stage outputs 1 and 2 are skips 2 and 1.
- Embedding: 1x1 conv with bias to ``hidden``, flattened to tokens, plus
  the position embedding.
- ``layers`` pre-norm blocks: LayerNorm (eps 1e-6), q, k, v and out
  linears with bias over ``heads`` heads, the residual; LayerNorm, fc1,
  exact GELU, fc2, the residual. A final LayerNorm.
- Decoder: the tokens as a (hidden, H/16, W/16) map; 3x3 conv-BN-ReLU to
  512; per block a bilinear x2 upsample with aligned corners, the skip
  concatenated (the first ``n_skip`` blocks), two 3x3 conv-BN-ReLU
  (BatchNorm eps 1e-5, no conv bias). A 3x3 head with bias.

Departures from the published code, as the port's ``models/transunet.py``
makes them: (a) the skips are zero-padded at the bottom and right to
(H/4, W/4) and (H/8, W/8), and the token grid is (H/16, W/16), where the
published code pads to a square and reshapes to a square grid; (b) the
position embedding is drawn from the seed at that grid (the published one
is learned at 14x14 and resized); (c) input: the grey B-scan over 3
channels, ``x / 255``; (d) no dropout; (e) ``num_classes`` outputs.

Parameter names and shapes are the served module's ``state_dict``'s.

The tests' copy of ``portbench/reference/transunet.py`` (which adds the
benchmark's FLOP counts): it imports nothing of either package, and the
benchmark's tests hold the two copies equal.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

STD_EPS, GN_EPS, PROJ_GN_EPS, LN_EPS, BN_EPS = 1e-5, 1e-6, 1e-5, 1e-6, 1e-5
GROUPS, HEAD_CHANNELS, PATCH = 32, 512, 16
DEFAULTS = dict(hidden=768, layers=12, heads=12, mlp=3072, resnet_units=(3, 4, 9), resnet_width=64,
                decoder_channels=(256, 128, 64, 16), n_skip=3)


def arch(cfg: dict) -> dict:
    """The architecture's sizes: ``cfg``'s, the published ones where absent."""
    return {k: cfg.get(k, v) for k, v in DEFAULTS.items()}


def units(cfg: dict) -> list:
    """``(prefix, cin, cout, mid, stride)`` of every bottleneck unit."""
    a, out, ch = arch(cfg), [], arch(cfg)["resnet_width"]
    i = 0
    for stage, n in enumerate(a["resnet_units"]):
        mid = a["resnet_width"] * 2**stage
        for u in range(n):
            out.append((f"hybrid.blocks.{i}", ch, 4 * mid, mid, 2 if stage > 0 and u == 0 else 1))
            ch, i = 4 * mid, i + 1
    return out


def decoder_convs(cfg: dict) -> list:
    """``(prefix, cin, cout)`` of ``conv_more`` and the decoder blocks' convs."""
    a = arch(cfg)
    w, n = a["resnet_width"], len(a["resnet_units"])
    skips = [4 * w * 2**s for s in reversed(range(n - 1))] + [w, 0]
    skips = [c if i < a["n_skip"] else 0 for i, c in enumerate(skips[: len(a["decoder_channels"])])]
    out = [("decoder.conv_more", a["hidden"], HEAD_CHANNELS)]
    ins = [HEAD_CHANNELS] + list(a["decoder_channels"][:-1])
    for i, (cin, skip, cout) in enumerate(zip(ins, skips, a["decoder_channels"])):
        out += [(f"decoder.blocks.{2 * i}", cin + skip, cout), (f"decoder.blocks.{2 * i + 1}", cout, cout)]
    return out


def tokens(cfg: dict) -> int:
    return (cfg["image_height"] // PATCH) * (cfg["image_width"] // PATCH)


def param_spec(cfg: dict) -> list:
    a = arch(cfg)
    hid, width = a["hidden"], a["resnet_width"]

    def norm(p, c):
        return [(f"{p}.weight", (c,), "bn_w"), (f"{p}.bias", (c,), "bn_b")]

    def linear(p, cin, cout):
        return [(f"{p}.weight", (cout, cin), "conv_w"), (f"{p}.bias", (cout,), "conv_b")]

    spec = [("hybrid.root.weight", (width, cfg["input_channels"], 7, 7), "conv_w")] + norm("hybrid.root_gn", width)
    for p, cin, cout, mid, stride in units(cfg):
        spec += [(f"{p}.conv1.weight", (mid, cin, 1, 1), "conv_w")] + norm(f"{p}.gn1", mid)
        spec += [(f"{p}.conv2.weight", (mid, mid, 3, 3), "conv_w")] + norm(f"{p}.gn2", mid)
        spec += [(f"{p}.conv3.weight", (cout, mid, 1, 1), "conv_w")] + norm(f"{p}.gn3", cout)
        if stride != 1 or cin != cout:
            spec += [(f"{p}.downsample.weight", (cout, cin, 1, 1), "conv_w")] + norm(f"{p}.gn_proj", cout)
    cin = units(cfg)[-1][2]
    spec += [("embed.position", (1, tokens(cfg), hid), "conv_b"),
             ("embed.patch.weight", (hid, cin, 1, 1), "conv_w"), ("embed.patch.bias", (hid,), "conv_b")]
    for layer in range(a["layers"]):
        p = f"encoder.blocks.{layer}"
        spec += norm(f"{p}.attention_norm", hid)
        for name in ("query", "key", "value", "out"):
            spec += linear(f"{p}.attn.{name}", hid, hid)
        spec += norm(f"{p}.ffn_norm", hid) + linear(f"{p}.ffn.fc1", hid, a["mlp"]) + linear(f"{p}.ffn.fc2", a["mlp"], hid)
    spec += norm("encoder.encoder_norm", hid)
    for p, cin, cout in decoder_convs(cfg):
        spec += [(f"{p}.conv.weight", (cout, cin, 3, 3), "conv_w")] + norm(f"{p}.bn", cout)
        spec += [(f"{p}.bn.running_mean", (cout,), "bn_mean"), (f"{p}.bn.running_var", (cout,), "bn_var")]
    last = a["decoder_channels"][-1]
    spec += [("head.weight", (cfg["num_classes"], last, 3, 3), "conv_w"), ("head.bias", (cfg["num_classes"],), "conv_b")]
    return spec


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.to(torch.float32) / 255.0


def std_conv(x, weight, stride=1, padding=0):
    mean = weight.mean(dim=(1, 2, 3), keepdim=True)
    var = ((weight - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    return F.conv2d(x, (weight - mean) / torch.sqrt(var + STD_EPS), None, stride, padding)


def group_norm(x, params, prefix, groups, eps):
    b, c, h, w = x.shape
    g = x.reshape(b, groups, -1)
    mean = g.mean(dim=-1, keepdim=True)
    var = ((g - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(b, c, h, w)
    return y * params[f"{prefix}.weight"][:, None, None] + params[f"{prefix}.bias"][:, None, None]


def layer_norm(x, params, prefix):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * params[f"{prefix}.weight"] + params[f"{prefix}.bias"]


def linear(x, params, prefix):
    return x @ params[f"{prefix}.weight"].t() + params[f"{prefix}.bias"]


def batchnorm(x, params, prefix, train: bool, stats=None):
    """Eval: the running statistics. Train: the batch's, biased variance,
    also kept in ``stats[prefix]`` where ``stats`` is a dict."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
        if stats is not None:
            stats[prefix] = (mean, var)
    else:
        mean, var = params[f"{prefix}.running_mean"], params[f"{prefix}.running_var"]
    y = (x - mean[:, None, None]) / torch.sqrt(var + BN_EPS)[:, None, None]
    return y * params[f"{prefix}.weight"][:, None, None] + params[f"{prefix}.bias"][:, None, None]


def _pad_to(x, h, w):
    if not (0 <= h - x.shape[2] < 3 and 0 <= w - x.shape[3] < 3):
        raise ValueError(f"skip of {tuple(x.shape[2:])} cannot be padded to {(h, w)}")
    return F.pad(x, (0, w - x.shape[3], 0, h - x.shape[2]))


def hybrid(params, x, cfg):
    """-> (the 1/16 map, [skip 1/8, skip 1/4, skip 1/2])."""
    a = arch(cfg)
    h, w = x.shape[2], x.shape[3]
    y = F.relu(group_norm(std_conv(x, params["hybrid.root.weight"], 2, 3), params, "hybrid.root_gn", GROUPS, GN_EPS))
    skips = [y]
    y = F.max_pool2d(y, 3, 2)
    ends = {sum(a["resnet_units"][: s + 1]) - 1: s for s in range(len(a["resnet_units"]) - 1)}
    for i, (p, cin, cout, _mid, stride) in enumerate(units(cfg)):
        if stride != 1 or cin != cout:
            residual = group_norm(std_conv(y, params[f"{p}.downsample.weight"], stride), params, f"{p}.gn_proj",
                                  cout, PROJ_GN_EPS)
        else:
            residual = y
        z = F.relu(group_norm(std_conv(y, params[f"{p}.conv1.weight"]), params, f"{p}.gn1", GROUPS, GN_EPS))
        z = F.relu(group_norm(std_conv(z, params[f"{p}.conv2.weight"], stride, 1), params, f"{p}.gn2", GROUPS, GN_EPS))
        z = group_norm(std_conv(z, params[f"{p}.conv3.weight"]), params, f"{p}.gn3", GROUPS, GN_EPS)
        y = F.relu(residual + z)
        if i in ends:
            div = 4 * 2 ** ends[i]
            skips.append(_pad_to(y, h // div, w // div))
    return y, skips[::-1]


def encoder(params, t, cfg):
    a = arch(cfg)
    b, n, c = t.shape
    heads = a["heads"]
    d = c // heads

    def split(u):
        return u.reshape(b, n, heads, d).permute(0, 2, 1, 3)

    for layer in range(a["layers"]):
        p = f"encoder.blocks.{layer}"
        u = layer_norm(t, params, f"{p}.attention_norm")
        q, k, v = (split(linear(u, params, f"{p}.attn.{name}")) for name in ("query", "key", "value"))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        t = t + linear((attn @ v).permute(0, 2, 1, 3).reshape(b, n, c), params, f"{p}.attn.out")
        u = linear(layer_norm(t, params, f"{p}.ffn_norm"), params, f"{p}.ffn.fc1")
        u = 0.5 * u * (1.0 + torch.erf(u / math.sqrt(2.0)))
        t = t + linear(u, params, f"{p}.ffn.fc2")
    return layer_norm(t, params, "encoder.encoder_norm")


def logits(params: dict, x: torch.Tensor, cfg: dict, train: bool = False, keep=None, stats=None):
    """Preprocessed ``(B, H, W, 3)`` -> ``(B, classes, H, W)`` logits;
    ``train`` takes the decoder BatchNorms' batch statistics, kept in
    ``stats`` where it is a dict (there is no dropout: ``keep`` is
    unused)."""
    a = arch(cfg)
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    y, skips = hybrid(params, x.permute(0, 3, 1, 2), cfg)
    t = F.conv2d(y, params["embed.patch.weight"], params["embed.patch.bias"]).flatten(2).transpose(1, 2)
    t = encoder(params, t + params["embed.position"], cfg)
    y = t.transpose(1, 2).reshape(b, a["hidden"], h // PATCH, w // PATCH)

    def block(prefix, y):
        y = F.conv2d(y, params[f"{prefix}.conv.weight"], None, padding=1)
        return F.relu(batchnorm(y, params, f"{prefix}.bn", train, stats))

    convs = decoder_convs(cfg)
    y = block(convs[0][0], y)
    for i in range(len(a["decoder_channels"])):
        y = F.interpolate(y, size=(2 * y.shape[2], 2 * y.shape[3]), mode="bilinear", align_corners=True)
        if i < a["n_skip"]:
            y = torch.cat([y, skips[i]], dim=1)
        y = block(convs[2 * i + 2][0], block(convs[2 * i + 1][0], y))
    return F.conv2d(y, params["head.weight"], params["head.bias"], padding=1)
