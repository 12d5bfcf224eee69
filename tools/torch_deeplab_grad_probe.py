#!/usr/bin/env python3
"""Where a float32 DeepLabV3+ train step's gradients part from float64's,
for the PyTorch port.

    python3 tools/torch_deeplab_grad_probe.py [--device cpu|cuda] [--seed 0]
        [--batch 2] [--height 64] [--width 128]

One train step (focal + Dice, Adam) of the full-width DeepLabV3+ (ResNet50
to conv4, 4 classes, 3 input channels) from seeded weights and batch; the
default shape is that of ``chip_smoke.py``'s card-vs-CPU DeepLab step
check. Each float32 variant runs on ``--device``; every float64 step runs
on the CPU and takes the ReLU gates and max-pool picks of the float32
variant it is held against, so that only rounding is left. For each
variant it prints the worst tensors' max |d| relative to that tensor's
largest float64 gradient (the biases of convs that feed a BatchNorm, whose
exact gradient is 0, left out):

- float32 as the port computes it;
- float32 with the batch statistics of every BatchNorm taken in float64
  and rounded to float32;
- float32 with every BatchNorm, or the DSPP's pooled branch's alone (it
  normalises over the batch alone), computed whole in float64, forward and
  backward (the input cast up, the output cast back to float32);
- float32 with every convolution in float64, likewise, and with every
  convolution and every BatchNorm;
- float64 with the convolutions and BatchNorms of one part of the model
  (the stem ``conv1``, each backbone stage, the DSPP, the decoder's
  blocks) in float32, their inputs rounded to float32 and their outputs
  cast back: what that part's float32 arithmetic adds on its own.

It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    DL_CHECK_BATCH,
    DL_CHECK_H,
    DL_CHECK_W,
    NUM_CLASSES,
    GateRecorder,
    build_deeplab,
    deeplab_functional,
    layered_dataset,
    rgb,
)
from oct_image_segmentation_models_torch.models import unet as unet_module  # noqa: E402
from oct_image_segmentation_models_torch.ops import losses, metrics  # noqa: E402
from oct_image_segmentation_models_torch.parallel import train_step as ts  # noqa: E402

ORIGINAL_BN = unet_module.BatchNorm.forward
GROUPS = {
    "every BatchNorm": lambda name: True,
    "the DSPP's pooled branch": lambda name: name.startswith("dspp.blocks.0."),
}
PARTS = {
    "the stem": lambda name: name.startswith("resnet50.conv1_"),
    "backbone stage conv2": lambda name: name.startswith("resnet50.conv2_"),
    "backbone stage conv3": lambda name: name.startswith("resnet50.conv3_"),
    "backbone stage conv4": lambda name: name.startswith("resnet50.conv4_"),
    "the DSPP": lambda name: name.startswith("dspp."),
    "the decoder's blocks": lambda name: name.startswith("blocks."),
    "every convolution": lambda name: True,
}


def compute_in(layer: torch.nn.Module, dtype: torch.dtype) -> None:
    """Make ``layer`` compute in ``dtype``, forward and backward, between
    neighbours of the other float type."""
    other = torch.float32 if dtype == torch.float64 else torch.float64
    layer.to(dtype)
    layer.register_forward_pre_hook(
        lambda m, args: tuple(a.to(dtype) if torch.is_tensor(a) else a for a in args)
    )
    layer.register_forward_hook(lambda m, args, out: out.to(other))


def bn_float64(self, x, batch_stats=False):
    """``unet.BatchNorm.forward`` in train mode with the batch mean and
    variance taken in float64 and rounded to the input's dtype (the
    BatchNorms marked ``_float64 = "statistics"``) or computed whole in
    float64 (``"whole"``). The running statistics are left as they are:
    only the gradients are read."""
    mode = getattr(self, "_float64", None)
    if not (batch_stats and mode):
        return ORIGINAL_BN(self, x, batch_stats)
    xd = x.double()
    mean = xd.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xd * xd).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    if mode == "whole":
        mul = torch.rsqrt(var + self.eps) * self.weight.double()
        y = (xd - mean[:, None, None]) * mul[:, None, None] + self.bias.double()[:, None, None]
        return y.to(x.dtype)
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    mul = torch.rsqrt(var + self.eps) * self.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=DL_CHECK_BATCH)
    parser.add_argument("--height", type=int, default=DL_CHECK_H)
    parser.add_argument("--width", type=int, default=DL_CHECK_W)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    cpu = torch.device("cpu")

    container, initial = build_deeplab(args.seed + 2, args.height, args.width, device="cpu")
    images, labels = layered_dataset(
        np.random.default_rng(args.seed), args.batch, args.height, args.width, NUM_CLASSES
    )
    x = torch.from_numpy(container.get_preprocess_input_fn()(rgb(images)))
    y = torch.from_numpy(labels)
    loss_fn = losses.focal_dice_loss(num_classes=NUM_CLASSES)
    metric_fn = metrics.dice_coef_macro(True, NUM_CLASSES)

    def grads(dtype, dev, recorder, group=None, mode=None):
        module = copy.deepcopy(initial).to(device=dev, dtype=dtype)
        for name, m in module.named_modules():
            if isinstance(m, unet_module.BatchNorm):
                if mode == "both":
                    m._float64 = "whole"
                elif mode in ("statistics", "whole") and GROUPS[group](name):
                    m._float64 = mode
            if isinstance(m, torch.nn.Conv2d) and (
                mode == "both" or mode == "convolutions" and PARTS[group](name)
            ):
                compute_in(m, torch.float64)
            if (
                mode == "only"
                and isinstance(m, (torch.nn.Conv2d, unet_module.BatchNorm))
                and PARTS[group](name)
            ):
                compute_in(m, torch.float32)
        state = ts.create_train_state(module, ts.build_optimizer("adam", {}))
        step = ts.make_train_step(module, loss_fn, metric_fn)
        with deeplab_functional(recorder):
            step(state, x.to(dev), y.to(dev), None)
        return {k: p.grad.detach().cpu().double() for k, p in module.named_parameters()}

    def worst(got, want, n=3):
        rows = sorted(
            (
                (float((got[k] - g).abs().max()) / float(g.abs().max()), k)
                for k, g in want.items()
                # exact gradient 0: the bias of a conv that feeds a BatchNorm
                if not (k.endswith("conv.bias") and not k.startswith("head."))
            ),
            reverse=True,
        )
        return ", ".join(f"{r:.3e} ({k})" for r, k in rows[:n])

    variants = [
        (None, None),
        ("every BatchNorm", "statistics"),
        ("every BatchNorm", "whole"),
        ("the DSPP's pooled branch", "whole"),
        ("every convolution", "convolutions"),
        ("every convolution and BatchNorm", "both"),
    ] + [(part, "only") for part in PARTS if part != "every convolution"]
    unet_module.BatchNorm.forward = bn_float64
    try:
        print(
            f"deeplab train step, batch {args.batch} x {args.height}x{args.width}, float32 on "
            f"{args.device}, against float64 with the same ReLU gates and max-pool picks:"
        )
        for group, mode in variants:
            rec32 = GateRecorder()
            dtype = torch.float64 if mode == "only" else torch.float32
            g32 = grads(dtype, device if mode != "only" else cpu, rec32, group, mode)
            g64 = grads(torch.float64, cpu, GateRecorder(rec32))
            label = (
                "as computed" if group is None
                else f"float64 in {group}" if mode == "both"
                else f"float32 only in {group}" if mode == "only"
                else f"float64 {mode} in {group}"
            )
            print(f"  {label}: worst tensors {worst(g32, g64)}", flush=True)
    finally:
        unet_module.BatchNorm.forward = ORIGINAL_BN
    return 0


if __name__ == "__main__":
    sys.exit(main())
