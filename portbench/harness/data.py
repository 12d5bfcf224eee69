"""Inputs made from the seed: random streams, the pool of synthetic
B-scans, the weights and the order of the traffic.

Every draw comes from ``numpy.random.default_rng([seed, stream])`` or a
``torch.Generator`` seeded from one, so that one seed gives one run's
inputs and two streams never overlap.
"""

from __future__ import annotations

import numpy as np
import torch

# Streams of one seed.
POOL, ORDER, WEIGHTS, CHOICES, STEPS, SAMPLE = range(6)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` of ``stream``."""
    return int(rng(seed, stream).integers(0, 2**63 - 1))


def layered_dataset(rng_: np.random.Generator, n: int, h: int, w: int, num_classes: int):
    """``(images (n, h, w, 1) uint8, labels (n, h, w, 1) uint8)``:
    ``num_classes`` layers with smooth wiggling boundaries, a grey level
    per layer and Gaussian noise."""
    rows = np.arange(h)[:, None]
    levels = np.linspace(40, 220, num_classes)
    out = np.empty((n, h, w, 1), np.uint8)
    out_labels = np.empty((n, h, w, 1), np.uint8)
    for i in range(n):
        bounds = []
        for cls in range(1, num_classes):
            base = h * cls / num_classes + rng_.integers(-h // 16, h // 16)
            wiggle = np.cumsum(rng_.integers(-1, 2, size=w))
            bounds.append(np.clip(base + wiggle - wiggle.mean(), 1, h - 2))
        bounds = np.sort(np.stack(bounds), axis=0)
        labels = (rows[None] >= bounds[:, None, :]).sum(0)
        image = levels[labels] + rng_.normal(0, 8.0, size=(h, w))
        out[i, ..., 0] = np.clip(image, 0, 255).astype(np.uint8)
        out_labels[i, ..., 0] = labels
    return out, out_labels


def make_pool(seed: int, config: dict, traffic: dict):
    """The cell's pool of layered B-scans and their labels."""
    kw = config["model"]["kwargs"]
    return layered_dataset(rng(seed, POOL), traffic["pool"], kw["image_height"], kw["image_width"],
                           kw["num_classes"])


def make_weights(spec: list, seed: int, device, dtype=torch.float32) -> dict:
    """``{name: tensor}`` for a reference's ``param_spec``, drawn on
    ``device`` in one call: conv kernels He-normal, conv biases and
    BatchNorm shifts N(0, 0.05), BatchNorm scales 1 + N(0, 0.1), running
    means N(0, 0.1), running variances exp(N(0, 0.2))."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, WEIGHTS))
    sizes = [int(np.prod(shape)) for _n, shape, _k in spec]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        z = flat[at : at + size].view(shape)
        at += size
        if kind == "conv_w":
            t = z * (2.0 / (size // shape[0])) ** 0.5
        elif kind in ("conv_b", "bn_b"):
            t = 0.05 * z
        elif kind == "bn_w":
            t = 1.0 + 0.1 * z
        elif kind == "bn_mean":
            t = 0.1 * z
        elif kind == "bn_var":
            t = torch.exp(0.2 * z)
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = t.to(dtype).contiguous()
    return out


def calibrate(ref, weights: dict, cfg: dict, images_u8: np.ndarray, device) -> None:
    """Set every BatchNorm's running statistics to its batch statistics
    on ``images_u8`` (the reference in train mode, without dropout), as a
    trained network's statistics match its data: the eval forward then
    sees activations of the scale a deployment sees."""
    from ..reference import precision

    stats = {}
    with torch.no_grad(), precision(True):
        x = ref.preprocess(torch.from_numpy(images_u8).to(device))
        ref.logits(weights, x, cfg, train=True, stats=stats)
    for prefix, (mean, var) in stats.items():
        weights[f"{prefix}.running_mean"] = mean.contiguous()
        weights[f"{prefix}.running_var"] = var.contiguous()


def block_order(seed: int, block: list, count: int) -> list:
    """``count`` entries of ``block`` repeated, each repetition in its own
    order drawn from the seed: every seed gets the same multiset of work
    per block, in another order."""
    r = rng(seed, ORDER)
    out = []
    while len(out) < count:
        out += [block[i] for i in r.permutation(len(block))]
    return out[:count]
