"""Host batch generation, a numpy copy of the JAX package's
``common/data_generator.py`` (the reference's ``BatchGenerator``).

With the same ``seed`` its ``np.random.default_rng`` stream gives the same
batches, augmentation choices and shuffles as the JAX package's, bit for
bit, and ``get_state`` / ``set_state`` carry that stream across an exact
resume.

Semantics, as in the JAX package:
- images are normalised to [0, 1] at construction, then de-normalised
  (x255) and passed through the model's ``preprocess_input`` per sample;
- augmentation modes ``none`` / ``one`` (a probabilistic choice per
  sample) / ``all`` (every augmentation per image), on the fly or
  precomputed (stored as float32);
- the epoch order is a permutation, reshuffled at every epoch end when
  ``shuffle``; batches drop the remainder.
"""

from __future__ import annotations

from math import floor
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import AUG_MODES


class BatchGenerator:
    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        aug_fn_args: List[Tuple],
        aug_mode: str,
        aug_probs: Tuple,
        aug_fly: bool,
        preprocess_input_fn: Callable,
        shuffle: bool = True,
        seed: Optional[int] = None,
        aug_device: bool = False,
    ):
        if aug_mode not in AUG_MODES:
            raise ValueError(
                f"Unrecognized augmentation mode: {aug_mode}. "
                f"Allowed values: {AUG_MODES}"
            )
        if aug_device and not aug_fly:
            raise ValueError("aug_device requires aug_fly=True")
        if aug_mode in ("one", "all") and not aug_fn_args:
            # Fail at construction: with no augmentations, "all" yields
            # zero samples per epoch and "one" crashes at the first
            # batch inside rng.choice — both after dataset loading.
            raise ValueError(
                f"aug_mode={aug_mode!r} requires a non-empty augmentations "
                "list; use aug_mode='none' to train without augmentation"
            )
        if aug_mode == "one" and aug_probs is not None and len(aug_probs):
            # Fail at construction, not at the first batch's rng.choice
            # (after dataset loading): the probabilities must pair 1:1 with the
            # augmentations and sum to 1. Coerced to a tuple so a numpy
            # array doesn't hit `self.aug_probs or None`'s ambiguous
            # truth value below.
            aug_probs = tuple(float(p) for p in aug_probs)
            if len(aug_probs) != len(aug_fn_args):
                raise ValueError(
                    f"aug_probs has {len(aug_probs)} entries for "
                    f"{len(aug_fn_args)} augmentations"
                )
            if abs(sum(aug_probs) - 1.0) > 1e-6:
                raise ValueError(
                    f"aug_probs must sum to 1, got {sum(aug_probs)!r}"
                )
        self.images = np.asarray(images, np.float32) / 255.0
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        self.aug_fn_args = aug_fn_args
        self.aug_mode = aug_mode
        self.aug_probs = aug_probs
        self.aug_fly = aug_fly
        self.aug_device = aug_device
        self.preprocess_input_fn = preprocess_input_fn
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

        self.batch_counter = 0
        self.full_counter = 0
        self.aug_counter = 0

        self.total_full_images = self.images.shape[0]
        self.total_raw_samples = self.total_full_images
        self.image_height = self.images.shape[1]
        self.image_width = self.images.shape[2]
        self.num_channels = self.images.shape[3]
        self.labels_shape = self.labels.shape

        if aug_mode == "none":
            self.total_augs = 0
            self.total_samples = self.total_raw_samples
        elif aug_mode == "all":
            self.total_augs = len(aug_fn_args)
            self.total_samples = self.total_raw_samples * self.total_augs
        else:  # "one"
            self.total_augs = len(aug_fn_args)
            self.total_samples = self.total_raw_samples

        self.batch_labels_shape = (batch_size,) + self.labels_shape[1:]

        if not aug_fly and aug_mode != "none":
            self.aug_images, self.aug_labels = self._setup_augnofly_data()

        self.sample_shuffle = np.arange(self.total_full_images)
        self.num_batches = int(floor(1.0 * self.total_samples / self.batch_size))
        self.handle_epoch_end()

    def _call_aug(self, aug_fn, image, label, aug_arg):
        """Host-side aug call with the generator's seeded RNG threaded in.

        Stochastic augs (add_noise) draw from ``aug_args['rng']`` when
        present; without this every call would fall back to fresh OS
        entropy, voiding the seed-reproducibility guarantee and the
        bitwise-exact resume (the RNG stream is part of get_state()).
        """
        if isinstance(aug_arg, dict) and "rng" not in aug_arg:
            aug_arg = dict(aug_arg, rng=self._rng)
        return aug_fn(image, label, aug_arg)

    def _setup_augnofly_data(self):
        aug_images = np.zeros(
            (self.total_full_images, self.total_augs)
            + self.images.shape[1:],
            dtype=np.float32,
        )
        aug_labels = np.zeros(
            (self.total_full_images, self.total_augs) + self.labels_shape[1:],
            dtype=self.labels.dtype,
        )
        for i in range(self.total_full_images):
            for j in range(self.total_augs):
                aug_fn, aug_arg = self.aug_fn_args[j]
                aug_images[i, j], aug_labels[i, j] = self._call_aug(
                    aug_fn, self.images[i], self.labels[i], aug_arg
                )
        return aug_images, aug_labels

    def _finalize(self, image):
        return self.preprocess_input_fn(np.asarray(image) * 255.0)

    def _next_sample(self, sample_ind):
        """-> (image, label, aug_choice). ``aug_choice`` is the index the
        mode logic picked (-1 = none); with ``aug_device`` the aug is NOT
        applied here — the device pipeline applies it from the choice."""
        raw_image = self.images[sample_ind]
        raw_label = self.labels[sample_ind]
        choice = -1

        if self.aug_mode == "all":
            choice = self.aug_counter
            if self.aug_device:
                image, label = raw_image, raw_label
            elif self.aug_fly:
                aug_fn, aug_arg = self.aug_fn_args[self.aug_counter]
                image, label = self._call_aug(
                    aug_fn, raw_image, raw_label, aug_arg
                )
            else:
                image = self.aug_images[sample_ind, self.aug_counter]
                label = self.aug_labels[sample_ind, self.aug_counter]
            self.aug_counter += 1
            if self.aug_counter == self.total_augs:
                self.aug_counter = 0
                self.full_counter += 1
        elif self.aug_mode == "one":
            choice = int(
                self._rng.choice(
                    np.arange(self.total_augs), p=self.aug_probs or None
                )
            )
            if self.aug_device:
                image, label = raw_image, raw_label
            elif self.aug_fly:
                aug_fn, aug_arg = self.aug_fn_args[choice]
                image, label = self._call_aug(
                    aug_fn, raw_image, raw_label, aug_arg
                )
            else:
                image = self.aug_images[sample_ind, choice]
                label = self.aug_labels[sample_ind, choice]
            self.full_counter += 1
        else:
            image, label = raw_image, raw_label
            self.full_counter += 1

        if self.aug_device:
            # raw [0, 1] image out; finalize runs on device after the aug
            return image, label, choice
        return self._finalize(image), label, choice

    def get_batch_list(self):
        """[images, labels] — or [images, labels, aug_choices] with
        ``aug_device`` (images raw [0, 1], choices (B,) int32)."""
        batch_images = np.zeros(
            (self.batch_size, self.image_height, self.image_width, self.num_channels),
            dtype=np.float32,
        )
        # labels dtype, not np.zeros' float64 default: a float64 batch
        # would double the label bytes uploaded per step
        batch_labels = np.zeros(self.batch_labels_shape, dtype=self.labels.dtype)
        batch_choices = np.full((self.batch_size,), -1, np.int32)

        for cur in range(self.batch_size):
            sample_ind = self.sample_shuffle[self.full_counter]
            (
                batch_images[cur],
                batch_labels[cur],
                batch_choices[cur],
            ) = self._next_sample(sample_ind)
            if self.full_counter == self.total_full_images:
                self.full_counter = 0

        self.batch_counter += 1
        if self.batch_counter == self.num_batches:
            self.batch_counter = 0
        if self.aug_device:
            return [batch_images, batch_labels, batch_choices]
        return [batch_images, batch_labels]

    def handle_epoch_end(self):
        self.batch_counter = 0
        self.full_counter = 0
        self.aug_counter = 0
        if self.shuffle:
            perm = self._rng.permutation(self.total_raw_samples)
            self.sample_shuffle = self.sample_shuffle[perm]

    def get_state(self) -> dict:
        """Snapshot of the sampling state (RNG stream + shuffle order +
        counters) — captured at an epoch boundary it is exactly the
        start-of-next-epoch state, enabling bitwise-exact training
        resume (training.py::save_train_state). ``sample_shuffle`` stays
        an ndarray: save_train_state stores it as a compact npz array
        rather than a dataset-sized JSON list."""
        return {
            "rng_state": self._rng.bit_generator.state,
            "sample_shuffle": np.array(self.sample_shuffle),
            "counters": [
                self.batch_counter,
                self.full_counter,
                self.aug_counter,
            ],
        }

    def set_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng_state"]
        self.sample_shuffle = np.asarray(
            state["sample_shuffle"], self.sample_shuffle.dtype
        )
        (
            self.batch_counter,
            self.full_counter,
            self.aug_counter,
        ) = state["counters"]


class DataGenerator:
    """Epoch-iterable wrapper (the reference subclasses
    ``keras.utils.Sequence``, `data_generator.py:372-416`)."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        aug_fn_args: List[Tuple],
        aug_mode: str,
        aug_probs: Tuple,
        aug_fly: bool,
        preprocess_input_fn: Callable,
        shuffle: bool = True,
        seed: Optional[int] = None,
        aug_device: bool = False,
    ):
        self.batch_gen = BatchGenerator(
            images=images,
            labels=labels,
            batch_size=batch_size,
            aug_fn_args=aug_fn_args,
            aug_mode=aug_mode,
            aug_probs=aug_probs,
            aug_fly=aug_fly,
            preprocess_input_fn=preprocess_input_fn,
            shuffle=shuffle,
            seed=seed,
            aug_device=aug_device,
        )

    def __len__(self):
        return self.batch_gen.num_batches

    def __getitem__(self, index):
        return self.batch_gen.get_batch_list()

    def __iter__(self):
        for _ in range(len(self)):
            yield self.batch_gen.get_batch_list()

    def on_epoch_end(self):
        self.batch_gen.handle_epoch_end()

    def get_state(self) -> dict:
        return self.batch_gen.get_state()

    def set_state(self, state: dict) -> None:
        self.batch_gen.set_state(state)

    def get_total_samples(self) -> int:
        return self.batch_gen.total_samples
