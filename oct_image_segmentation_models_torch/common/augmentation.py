"""Host augmentations, a numpy copy of the JAX package's
``common/augmentation.py`` (the reference's registry and call shape
``aug_fn(image, mask, aug_args, desc_only=False) -> (image, mask) | str``,
on images normalised to [0, 1]).

``add_noise`` follows skimage ``random_noise``: float output clipped to
[0, 1]; modes gaussian, speckle, salt, pepper, s&p. The batched device
versions of flip and gaussian/speckle noise are in :mod:`..ops.augment`.
"""

from __future__ import annotations

import time

import numpy as np


def no_aug(image, mask, _aug_args, desc_only=False):
    if desc_only:
        return "no aug"
    return image, mask


def flip_aug(image, mask, aug_args, desc_only=False):
    """Up-down / left-right flip — reference `augmentation.py:51-69`."""
    flip_type = aug_args["flip_type"]
    if flip_type == "up-down":
        axis = 0
    elif flip_type == "left-right":
        axis = 1
    else:
        raise ValueError(f"Unknown flip_type: {flip_type}")

    if desc_only:
        return "flip aug: " + flip_type

    aug_image = np.flip(image, axis=axis)
    aug_mask = np.flip(mask, axis=axis) if mask is not None else None
    return aug_image, aug_mask


def _random_noise(image, mode, mean, var, rng):
    image = np.asarray(image, dtype=np.float64)
    if mode == "gaussian":
        out = image + rng.normal(mean, var**0.5, image.shape)
    elif mode == "speckle":
        out = image + image * rng.normal(mean, var**0.5, image.shape)
    elif mode in ("salt", "pepper", "s&p"):
        amount = 0.05 if var is None else var
        out = image.copy()
        flips = rng.random(image.shape) < amount
        if mode == "salt":
            out[flips] = 1.0
        elif mode == "pepper":
            out[flips] = 0.0
        else:
            salt_vs_pepper = rng.random(image.shape) < 0.5
            out[flips & salt_vs_pepper] = 1.0
            out[flips & ~salt_vs_pepper] = 0.0
    else:
        raise ValueError(f"Unsupported noise mode: {mode}")
    return np.clip(out, 0.0, 1.0)


def add_noise_aug(image, mask, aug_args, desc_only=False):
    """Additive noise on [0, 1] images — reference `augmentation.py:72-96`."""
    if desc_only:
        return "add noise: " + str(aug_args)
    mode = aug_args["mode"]
    mean = aug_args.get("mean", 0.0)
    variance = aug_args.get("variance", 0.01)
    # Callers wanting reproducibility pass a seeded Generator under "rng"
    # (BatchGenerator threads its own resumable stream in automatically).
    rng = aug_args.get("rng")
    if rng is None:
        rng = np.random.default_rng()
    return _random_noise(image, mode, mean, variance, rng), mask


augmentation_map = {
    "add_noise": add_noise_aug,
    "flip": flip_aug,
    "no_augmentation": no_aug,
}


def augment_dataset(images, masks, segs, aug_fn_arg):
    """Batch helper for offline tooling — reference `augmentation.py:6-40`."""
    start = time.time()
    aug_fn, aug_arg = aug_fn_arg
    augmented_images = np.zeros_like(images)
    augmented_masks = np.zeros_like(masks)
    augmented_segs = np.zeros_like(segs) if segs is not None else None
    for i in range(len(images)):
        img, msk = aug_fn(images[i], masks[i], aug_arg)
        augmented_images[i], augmented_masks[i] = img, msk
        if segs is not None:
            augmented_segs[i] = segs[i]
    desc = aug_fn(None, None, aug_arg, True)
    return [augmented_images, augmented_masks, augmented_segs, desc, time.time() - start]


def normalize(x):
    """Min-max normalise — reference `augmentation.py:106-108`."""
    x = np.asarray(x)
    return (x - x.min()) / np.ptp(x)
