"""Batched device augmentations, counterpart of the JAX package's
``ops/augment.py``.

The same transforms as the host ones in :mod:`..common.augmentation`, on
``(B, H, W, C)`` images in [0, 1] on the card; labels ride along untouched
except for flips. Noise is drawn from an explicit ``torch.Generator`` on
the images' device, so it follows the train step's generator stream; in
an spmd step over several ranks each rank draws the global batch's values
and keeps its rows (``parallel.mesh.draw_rows``).
"""

from __future__ import annotations

import functools
import math

import torch

from ..parallel import mesh as mesh_lib


def _flip_axis(flip_type: str) -> int:
    """Batch-array axis for a flip type; unknown names raise as the host
    ``flip_aug`` does."""
    if flip_type == "up-down":
        return 1
    if flip_type == "left-right":
        return 2
    raise ValueError(f"Unknown flip_type: {flip_type}")


def flip(images, labels, flip_type: str = "left-right"):
    """Batched flip (per sample: axis 0 up-down, axis 1 left-right)."""
    axis = _flip_axis(flip_type)
    return torch.flip(images, (axis,)), torch.flip(labels, (axis,))


def _noise(generator, images, mean, variance):
    draw = functools.partial(
        torch.randn, generator=generator, device=images.device, dtype=images.dtype
    )
    return mean + math.sqrt(variance) * mesh_lib.draw_rows(draw, images.shape)


def add_gaussian_noise(generator, images, mean: float = 0.0, variance: float = 0.01):
    """skimage ``random_noise(mode='gaussian')`` on [0, 1] images: additive
    N(mean, sqrt(var)), then clip."""
    return torch.clamp(images + _noise(generator, images, mean, variance), 0.0, 1.0)


def add_speckle_noise(generator, images, mean: float = 0.0, variance: float = 0.01):
    """skimage ``random_noise(mode='speckle')``: x + x * N(mean, sqrt(var))."""
    noise = _noise(generator, images, mean, variance)
    return torch.clamp(images + images * noise, 0.0, 1.0)


def random_flip(generator, images, labels, flip_type: str = "left-right", p=0.5):
    """Flip each sample independently with probability ``p``."""
    axis = _flip_axis(flip_type)
    draw = functools.partial(torch.rand, generator=generator, device=images.device)
    coins = mesh_lib.draw_rows(draw, (images.shape[0],)) < p
    sel_i = coins.reshape((-1,) + (1,) * (images.ndim - 1))
    sel_l = coins.reshape((-1,) + (1,) * (labels.ndim - 1))
    images = torch.where(sel_i, torch.flip(images, (axis,)), images)
    labels = torch.where(sel_l, torch.flip(labels, (axis,)), labels)
    return images, labels


def build_device_augmenter(aug_fn_args):
    """Per-sample device augmentation for the training input.

    ``aug_fn_args`` is the generator's list of (host aug fn, arg dict)
    pairs. When every augmentation has a device equivalent, returns

        ``apply(generator, images, labels, choices) -> (images, labels)``

    where ``choices`` is ``(B,)`` int32, the augmentation index the host
    generator's mode logic picked per sample, or -1 for none. Returns
    ``None`` when an augmentation has no device equivalent (e.g.
    salt/pepper noise), and the caller augments on the host.
    """
    from ..common.augmentation import add_noise_aug, flip_aug, no_aug

    # Every branch runs on the whole batch; per-sample masks then select
    # the generator's choice.
    noises = {"gaussian": add_gaussian_noise, "speckle": add_speckle_noise}
    branches = []
    for fn, arg in aug_fn_args:
        if fn is flip_aug:
            _flip_axis(arg["flip_type"])  # an unknown flip type raises here

            def mk_flip(flip_type=arg["flip_type"]):
                return lambda generator, img, lab: flip(img, lab, flip_type)

            branches.append(mk_flip())
        elif fn is add_noise_aug and arg.get("mode") in noises:

            def mk_noise(
                noise=noises[arg["mode"]],
                mean=float(arg.get("mean", 0.0)),
                var=float(arg.get("variance", 0.01)),
            ):
                return lambda generator, img, lab: (noise(generator, img, mean, var), lab)

            branches.append(mk_noise())
        elif fn is no_aug:
            branches.append(lambda generator, img, lab: (img, lab))
        else:
            return None

    def apply(generator, images, labels, choices):
        choices = choices.to(images.device)
        out_i, out_l = images, labels
        for k, b in enumerate(branches):
            bi, bl = b(generator, images, labels)
            sel = choices == k
            out_i = torch.where(sel.reshape((-1,) + (1,) * (images.ndim - 1)), bi, out_i)
            out_l = torch.where(sel.reshape((-1,) + (1,) * (labels.ndim - 1)), bl, out_l)
        return out_i, out_l

    return apply
