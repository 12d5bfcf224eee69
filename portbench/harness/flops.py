"""The yardstick's arithmetic: model FLOPs and the card's peaks.

Model FLOPs are the convolutions of the plain network at the cell's
shapes, 2 x multiply-adds, whatever the program computes in their place
(a space-to-depth or BN-folded forward counts the same). A training step
counts 3 x the forward. The peaks are NVIDIA's for one H100 SXM, dense.
"""

from __future__ import annotations

from ..reference import deeplab as deeplab_ref
from ..reference import unet as unet_ref

# Dense tensor-core rates by the cell's stated precision: a float32 cell
# is held against TF32's rate, the fastest route that keeps float32
# inputs (a 3xTF32 product does float32-accurate work above the 67
# TFLOP/s of the CUDA cores, so that rate could be beaten).
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def _conv(cin, cout, kh, kw, h, w) -> int:
    return 2 * cin * cout * kh * kw * h * w


def unet_forward_flops(cfg: dict, h: int, w: int) -> int:
    """One B-scan's forward through the U-Net of ``cfg``."""
    pools, convs = cfg["pool_layers"], cfg["conv_layers"]
    shapes = unet_ref.block_shapes(cfg)
    # Resolution divisor of each block, in block order.
    divs = []
    for level in range(pools):
        divs += [2**level] * convs
    divs += [2**pools] * convs
    for level in reversed(range(pools)):
        divs += [2**level] * (1 + convs)
    total = sum(_conv(ci, co, kh, kw, h // d, w // d) for (ci, co, (kh, kw)), d in zip(shapes, divs))
    return total + _conv(shapes[-1][1], cfg["num_classes"], 1, 1, h, w)


def deeplab_forward_flops(cfg: dict, h: int, w: int) -> int:
    """One B-scan's forward through the DeepLabV3+ of ``cfg``: the stem at
    stride 2, stage 2 at 4, 3 at 8, 4 at 16 (a strided conv counted at its
    output), the DSPP at 16 (its pooled branch at 1 x 1), the decoder at 4,
    the head at 1."""
    convs, _ = deeplab_ref._backbone_convs(cfg["input_channels"])
    total = 0
    for prefix, cin, cout, k, _s in convs:
        if prefix == "conv1":
            stride = 2
        else:
            stage = int(prefix[4])
            stride = {2: 4, 3: 8, 4: 16}[stage]
        total += _conv(cin, cout, k, k, h // stride, w // stride)
    for prefix, cin, cout, k, _d, _b in deeplab_ref.head_blocks():
        if prefix == "dspp.blocks.0":
            hw = (1, 1)
        elif prefix.startswith("dspp"):
            hw = (h // 16, w // 16)
        else:
            hw = (h // 4, w // 4)
        total += _conv(cin, cout, k, k, *hw)
    return total + _conv(deeplab_ref.FEATURES, cfg["num_classes"], 1, 1, h, w)


FORWARD_FLOPS = {"unet": unet_forward_flops, "deeplabv3plus": deeplab_forward_flops}


def forward_flops(config: dict) -> int:
    """One B-scan's model FLOPs for a configuration file's contents."""
    model = config["model"]
    return FORWARD_FLOPS[model["name"]](model["kwargs"], model["kwargs"]["image_height"],
                                        model["kwargs"]["image_width"])


def minpath_bytes(maps: int, h: int, w: int) -> int:
    """Bytes a min-path call over ``maps`` maps of ``h`` x ``w`` needs:
    each uint8 map read once, each int32 row written once."""
    return maps * h * w + maps * w * 4
