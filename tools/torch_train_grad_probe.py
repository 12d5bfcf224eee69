#!/usr/bin/env python3
"""Where a float32 train step's gradients part from float64's, for the
PyTorch port's U-Net.

    python3 tools/torch_train_grad_probe.py [--device cpu|cuda] [--seed 0]

One train step (focal + Dice, Adam) of the bench's U-Net (start_neurons=32,
pool_layers=4, conv_layers=2, 4 classes) at batch 2 of 128x256, the shape
of ``chip_smoke.py``'s card-vs-CPU step check, from seeded weights, batch
and dropout mask. The float32 step runs on ``--device``; every float64
step runs on the CPU. For each variant it prints the worst tensor's
max |d| relative to that tensor's largest float64 gradient:

- float32 against the plain float64 step;
- against float64 taking the float32 step's max-pool picks;
- against float64 taking its ReLU gates (x > 0);
- against float64 taking both;
- float32 with its BatchNorm batch statistics in float64, against the
  plain float64 step;

and how many ReLU gates and max-pool picks the float32 and float64
forwards disagree on. It imports nothing of JAX.
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
    CHECK_BATCH,
    CHECK_H,
    CHECK_W,
    NUM_CLASSES,
    GateRecorder,
    gate_flips,
    layered_dataset,
    unet_functional,
)
from oct_image_segmentation_models_torch.models import get_model_class  # noqa: E402
from oct_image_segmentation_models_torch.models import unet as unet_module  # noqa: E402
from oct_image_segmentation_models_torch.ops import losses, metrics  # noqa: E402
from oct_image_segmentation_models_torch.parallel import train_step as ts  # noqa: E402


def bn_float64_statistics(self, x, batch_stats=False):
    """``unet.BatchNorm.forward`` with the batch mean and variance taken in
    float64 and rounded to the input's dtype."""
    if not batch_stats:
        return ORIGINAL_BN(self, x, batch_stats)
    xd = x.double()
    mean = xd.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xd * xd).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    mul = torch.rsqrt(var + unet_module.BN_EPS) * self.weight
    return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


ORIGINAL_BN = unet_module.BatchNorm.forward


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device = torch.device(args.device)

    container = get_model_class("unet")(
        input_channels=1, num_classes=NUM_CLASSES, image_height=CHECK_H,
        image_width=CHECK_W, start_neurons=32, pool_layers=4, conv_layers=2,
    )
    initial = container.build_model(
        generator=torch.Generator().manual_seed(args.seed + 1), device="cpu"
    )
    images, labels = layered_dataset(
        np.random.default_rng(args.seed), CHECK_BATCH, CHECK_H, CHECK_W, NUM_CLASSES
    )
    x = torch.from_numpy(images.astype(np.float32) / 255.0)
    y = torch.from_numpy(labels)
    keep = {}

    def shared_mask(t, generator):
        if "mask" not in keep:
            draw = torch.rand(t.shape, generator=torch.Generator().manual_seed(args.seed))
            keep["mask"] = draw < 1.0 - unet_module.DROPOUT_RATE
        return keep["mask"].to(t.device)

    loss_fn = losses.focal_dice_loss(num_classes=NUM_CLASSES)
    metric_fn = metrics.dice_coef_macro(True, NUM_CLASSES)

    def grads(dtype, dev, recorder):
        module = copy.deepcopy(initial).to(device=dev, dtype=dtype)
        state = ts.create_train_state(module, ts.build_optimizer("adam", {}))
        step = ts.make_train_step(module, loss_fn, metric_fn)
        with unet_functional(recorder):
            step(state, x.to(dev), y.to(dev), None)
        return {k: p.grad.detach().cpu().double() for k, p in module.named_parameters()}

    unet_module.dropout_mask = shared_mask
    cpu = torch.device("cpu")
    rec32, rec64 = GateRecorder(), GateRecorder()
    g32 = grads(torch.float32, device, rec32)
    g64 = grads(torch.float64, cpu, rec64)
    unet_module.BatchNorm.forward = bn_float64_statistics
    try:
        g32_bn64 = grads(torch.float32, device, GateRecorder())
    finally:
        unet_module.BatchNorm.forward = ORIGINAL_BN
    variants = {
        "plain float64": (g32, g64),
        "float64 with float32's max-pool picks": (
            g32, grads(torch.float64, cpu, GateRecorder(rec32, gates=False))
        ),
        "float64 with float32's ReLU gates": (
            g32, grads(torch.float64, cpu, GateRecorder(rec32, picks=False))
        ),
        "float64 with both": (g32, grads(torch.float64, cpu, GateRecorder(rec32))),
        "float32 with float64 BN statistics vs plain float64": (g32_bn64, g64),
    }
    gates, picks = gate_flips(rec32, rec64)
    print(
        f"train step, batch {CHECK_BATCH} x {CHECK_H}x{CHECK_W}, start_neurons 32, float32 on "
        f"{args.device}: {gates} ReLU gates and {picks} max-pool picks differ from float64's "
        f"(of {sum(g.numel() for g in rec32.gates)} and {sum(p.numel() for p in rec32.picks)})"
    )
    for name, (got, want) in variants.items():
        worst = max(
            (float((got[k] - g).abs().max()) / float(g.abs().max()), k)
            for k, g in want.items()
            # exact gradient 0: the bias of a conv that feeds a BatchNorm
            if not (k.startswith("blocks.") and k.endswith("conv.bias"))
        )
        print(f"  {name}: worst tensor {worst[0]:.3e} of its max ({worst[1]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
