"""Offline dataset construction tooling, a numpy copy of the JAX
package's ``common/dataset_construction.py`` (the reference's
``common/dataset_construction.py``).

Array convention (the reference's): full-size images are ``(..., width,
height, channels)`` and patch labels ``(..., 1)``. ``create_area_mask``
delegates to the port's :func:`..ops.boundary.create_area_mask` on the
CPU. :func:`construct_dataset` writes through :mod:`.h5`.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from ..ops import boundary as boundary_ops
from . import h5


def construct_dataset(
    images,
    labels,
    segs,
    write_filename,
    trainvaltest,
    boundary_names,
    area_names,
    patch_class_names,
    fullsize_class_names,
    image_names,
    start_construct_time,
    patches,
    patch_labels,
    patch_col_range,
    patch_size,
    num_boundaries,
    num_areas,
    num_channels,
    dim_ordering,
    dim_names,
    alt_output,
    bg_mode="single",
    bg_margin=0,
):
    """Write the reference's HDF5 dataset layout (patch or fullsize) —
    reference `dataset_construction.py:28-210`. Returns the filename."""
    images = np.array(images, dtype="uint8")
    if labels is not None:
        labels = np.array(labels, dtype="uint8")

    if patches:
        labels = np.expand_dims(labels, axis=-1)
        patch_width, patch_height = patch_size
        bg_margin_str = f"_{bg_margin}marg" if bg_margin else ""
        filename = (
            f"{alt_output}{write_filename}_{patch_width}x{patch_height}"
            f"patches_{trainvaltest}_{bg_mode}{bg_margin_str}.hdf5"
        )
        save_file = h5.File(filename, "w")
        num_bgs = {
            "three": 3,
            "one": 1,
            "all": num_boundaries + 1,
            "extra": num_boundaries * 2 + 1,
        }.get(bg_mode)
        if num_bgs is not None:
            save_file.attrs["num_bgs"] = num_bgs
        save_file.attrs["image_width"] = patch_width
        save_file.attrs["image_height"] = patch_height
        save_file.attrs["patch_col_inc_bounds"] = np.array(
            [patch_col_range[0], patch_col_range[-1]]
        )
        save_file.attrs["type"] = np.array("patch", dtype="S100")
    else:
        channel_axis = -1 if dim_ordering == "channels_last" else -3
        if images.ndim < 4:
            images = np.expand_dims(images, axis=channel_axis)
        if labels is not None:
            labels = np.expand_dims(labels, axis=channel_axis)
        if patch_labels is not None:
            patch_labels = np.expand_dims(patch_labels, axis=channel_axis)

        multi_bg_str = f"_{bg_mode}" if patch_labels is not None else ""
        filename = (
            f"{alt_output}{write_filename}_fullsize_{trainvaltest}"
            f"{multi_bg_str}.hdf5"
        )
        save_file = h5.File(filename, "w")
        save_file.attrs["image_width"] = images.shape[-3]
        save_file.attrs["image_height"] = images.shape[-2]
        if patch_labels is not None:
            save_file.create_dataset(
                "patch_labels", data=patch_labels, dtype="uint8"
            )
        save_file.attrs["type"] = np.array("fullsize", dtype="S100")
        if segs is not None:
            save_file.create_dataset("segs", data=segs, dtype="uint16")
        if fullsize_class_names is not None:
            save_file.create_dataset(
                "fullsize_class_names", data=fullsize_class_names, dtype="S100"
            )

    save_file.attrs["num_channels"] = num_channels
    save_file.attrs["dim_ordering"] = np.array(dim_ordering, dtype="S100")
    save_file.attrs["dim_names"] = np.array(dim_names, dtype="S100")

    for name, data in (
        ("boundary_names", boundary_names),
        ("area_names", area_names),
        ("patch_class_names", patch_class_names),
        ("image_names", image_names),
    ):
        if data is not None:
            save_file.create_dataset(name, data=data, dtype="S100")

    save_file.attrs["name"] = np.array(write_filename, dtype="S100")
    save_file.attrs["num_boundaries"] = num_boundaries
    save_file.attrs["num_areas"] = num_areas
    save_file.attrs["set"] = np.array(trainvaltest, dtype="S100")

    save_file.create_dataset("images", data=images, dtype="uint8")
    if labels is not None:
        save_file.create_dataset("labels", data=labels, dtype="uint8")

    save_file.attrs["construct_time"] = time.time() - start_construct_time
    save_file.attrs["timestamp"] = np.array(
        datetime.datetime.now().strftime("%Y-%m-%d_%H:%M:%S"), dtype="S100"
    )
    save_file.close()
    return filename


def _valid_rows(seg_row):
    """Columns whose boundary row is usable (not NaN, not 0) + the int
    rows — reference's per-element validity test, vectorized."""
    vals = np.asarray(seg_row, dtype=np.float64)
    ok = ~np.isnan(vals) & (vals != 0)
    rows = np.zeros(vals.shape, dtype=np.int64)
    rows[ok] = vals[ok].astype(np.int64)
    return ok, rows


def create_patch_labels(image, segs, bg_mode="single", bg_margin=0, bg_splits=None):
    """Per-pixel class labels from boundary rows for patch sampling —
    reference `dataset_construction.py:233-308` (modes single/extra),
    vectorized per boundary (the reference writes column-by-column; the
    write ORDER across boundary indices is preserved, which is what
    determines overwrite semantics)."""
    image_width, image_height = image.shape[0], image.shape[1]
    num_boundaries = len(segs)
    patch_labels = np.zeros((image_width, image_height))
    cols = np.arange(image_width)

    if bg_mode == "single":
        for b in range(num_boundaries):
            ok, rows = _valid_rows(segs[b])
            patch_labels[cols[ok], rows[ok]] = b + 1
    elif bg_mode == "extra":
        # boundary pixels: classes 0..nb-1
        for b in range(num_boundaries):
            ok, rows = _valid_rows(segs[b])
            patch_labels[cols[ok], rows[ok]] = b
        # margin bands around each boundary: classes nb..2nb-1
        # (negative row indices wrap, like the reference's int(v)-k)
        for b in range(num_boundaries):
            ok, rows = _valid_rows(segs[b])
            for k in range(1, bg_margin + 1):
                patch_labels[cols[ok], rows[ok] - k] = num_boundaries + b
                patch_labels[cols[ok], rows[ok] + k] = num_boundaries + b
        # inter-boundary regions: classes 2nb..3nb (slice semantics per
        # column — a negative stop must keep the reference's Python-slice
        # wrapping, so these stay explicit slices)
        class_label = 2 * num_boundaries
        for layer_ind in range(num_boundaries + 1):
            if layer_ind == 0:
                ok, rows = _valid_rows(segs[0])
                spans = [(c, slice(None, rows[c] - bg_margin))
                         for c in cols[ok]]
            elif layer_ind == num_boundaries:
                ok, rows = _valid_rows(segs[-1])
                spans = [(c, slice(rows[c] + bg_margin, None))
                         for c in cols[ok]]
            else:
                ok_a, rows_a = _valid_rows(segs[layer_ind - 1])
                ok_b, rows_b = _valid_rows(segs[layer_ind])
                spans = [
                    (c, slice(rows_a[c] + bg_margin, rows_b[c] - bg_margin))
                    for c in cols[ok_a & ok_b]
                ]
            for c, span in spans:
                patch_labels[c, span] = class_label
            class_label += 1
    return patch_labels


def create_all_patch_labels(images, segs, bg_mode="single", bg_margin=0,
                            bg_splits=None):
    """Reference `dataset_construction.py:213-230`."""
    return np.array(
        [
            create_patch_labels(images[i], segs[i], bg_mode, bg_margin, bg_splits)
            for i in range(images.shape[0])
        ]
    )


def pad_patch_image(image, patch_size):
    """Symmetric zero pad by ceil(patch/2) — reference `:625-649`."""
    pw = int(np.ceil(patch_size[0] / 2.0))
    ph = int(np.ceil(patch_size[1] / 2.0))
    pad = [(pw, pw), (ph, ph)] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, pad, "constant")


def construct_patch(image, x, y, patch_size):
    """Patch with top-left at (col x, row y) of the padded image —
    reference `:366-392`."""
    return image[x : x + patch_size[0], y : y + patch_size[1]]


def construct_patches_whole_image(image, patch_labels, patch_size):
    """Patches centred at every pixel — reference `:311-363`."""
    start = time.time()
    img_width, img_height = image.shape[0], image.shape[1]
    padded = pad_patch_image(image, patch_size)
    patches = np.zeros(
        (img_width * img_height, patch_size[0], patch_size[1], 1), dtype="uint8"
    )
    labels = np.zeros((img_width * img_height, 1), dtype="uint8")
    for row in range(img_height):
        for col in range(img_width):
            patch = construct_patch(padded, col, row, patch_size)
            patches[row * img_width + col, :, :] = patch.reshape(
                patch_size[0], patch_size[1], -1
            )[:, :, :1]
            labels[row * img_width + col] = patch_labels[col, row]
    return patches, labels, time.time() - start


def choose_bg_ind(col, segs, bg_ind_min, bg_ind_max, rng=None):
    """Random background row avoiding boundary rows — reference `:601-622`."""
    rng = rng or np.random.default_rng()
    invalids = [segs[b, col] for b in range(len(segs))]
    bg_ind_min = int(bg_ind_min)
    bg_ind_max = int(bg_ind_max)
    while True:
        if bg_ind_max - bg_ind_min > 0:
            bg_ind = bg_ind_min + int(rng.integers(bg_ind_max - bg_ind_min))
        else:
            bg_ind = bg_ind_min
        if bg_ind == bg_ind_min or bg_ind not in invalids:
            return bg_ind


def sample_training_patches(
    image, segs, col_range, patch_size, bg_mode="single", bg_margin=0,
    bg_splits=None, rng=None,
):
    """Sample boundary + background patches per column — reference
    `:422-598` (modes single/three/all/extra/super)."""
    rng = rng or np.random.default_rng()
    num_boundaries = len(segs)
    image_width, image_height = image.shape[0], image.shape[1]
    patches, labels = [], []
    padded = pad_patch_image(image, patch_size)
    col_range = set(col_range)

    base_label = {
        "single": 1,
        "three": 3,
        "all": num_boundaries + 1,
        "extra": num_boundaries * 2 + 1,
        "super": num_boundaries + (sum(bg_splits) if bg_splits else 0),
    }[bg_mode]

    for col in range(image_width):
        if col not in col_range:
            continue
        class_label = base_label
        for b in range(num_boundaries):
            patches.append(construct_patch(padded, col, int(segs[b, col]), patch_size))
            labels.append(class_label)
            class_label += 1

        if bg_mode == "single":
            bg = choose_bg_ind(col, segs, 0, image_height, rng)
            patches.append(construct_patch(padded, col, bg, patch_size))
            labels.append(0)
        elif bg_mode == "three":
            regions = [
                (0, segs[0, col] - bg_margin, 0),
                (segs[0, col] - bg_margin, segs[-1, col] + bg_margin, 1),
                (segs[-1, col] + bg_margin, image_height, 2),
            ]
            for lo, hi, lab in regions:
                bg = choose_bg_ind(col, segs, lo, hi, rng)
                patches.append(construct_patch(padded, col, bg, patch_size))
                labels.append(lab)
        elif bg_mode == "all":
            for i in range(num_boundaries + 1):
                if i == 0:
                    bg = choose_bg_ind(col, segs, 0, segs[i, col], rng)
                elif i == num_boundaries:
                    bg = choose_bg_ind(col, segs, segs[-1, col] + 1, image_height, rng)
                else:
                    bg = choose_bg_ind(
                        col, segs, segs[i - 1, col] + 1, segs[i, col], rng
                    )
                patches.append(construct_patch(padded, col, bg, patch_size))
                labels.append(i)
        elif bg_mode in ("extra", "super"):
            for i in range(num_boundaries):
                bg1 = choose_bg_ind(
                    col, segs, segs[i, col] - bg_margin, segs[i, col], rng
                )
                bg2 = choose_bg_ind(
                    col, segs, segs[i, col] + 1, segs[i, col] + bg_margin, rng
                )
                bg = int(rng.choice([bg1, bg2]))
                patches.append(construct_patch(padded, col, bg, patch_size))
                labels.append(i)
            if bg_mode == "extra":
                for i in range(num_boundaries + 1):
                    if i == 0:
                        bg = choose_bg_ind(
                            col, segs, 0, segs[i, col] - bg_margin, rng
                        )
                    elif i == num_boundaries:
                        bg = choose_bg_ind(
                            col, segs, segs[-1, col] + bg_margin, image_height, rng
                        )
                    else:
                        bg = choose_bg_ind(
                            col,
                            segs,
                            segs[i - 1, col] + bg_margin,
                            segs[i, col] - bg_margin,
                            rng,
                        )
                    patches.append(construct_patch(padded, col, bg, patch_size))
                    labels.append(num_boundaries + i)
            else:  # super: stratified splits per inter-boundary region
                for i in range(num_boundaries + 1):
                    if i == 0:
                        lo, hi = 0, segs[i, col] - bg_margin
                    elif i == num_boundaries:
                        lo, hi = segs[-1, col] + bg_margin, image_height
                    else:
                        lo, hi = (
                            segs[i - 1, col] + bg_margin,
                            segs[i, col] - bg_margin,
                        )
                    split_step = int((hi - lo) / bg_splits[i])
                    for j in range(bg_splits[i]):
                        bg = int(
                            choose_bg_ind(
                                col,
                                segs,
                                lo + split_step * j,
                                lo + split_step * (j + 1),
                                rng,
                            )
                        )
                        patches.append(construct_patch(padded, col, bg, patch_size))
                        labels.append(num_boundaries + sum(bg_splits[:i]) + j)

    return patches, labels


def sample_all_training_patches(
    images, segs, col_range, patch_size, bg_mode="single", bg_margin=0,
    bg_splits=None,
):
    """Reference `:395-419`."""
    all_patches, all_labels = [], []
    for i in range(images.shape[0]):
        p, l = sample_training_patches(
            images[i], segs[i], col_range, patch_size, bg_mode, bg_margin,
            bg_splits,
        )
        all_patches.extend(p)
        all_labels.extend(l)
    return np.array(all_patches), np.array(all_labels)


def create_area_mask(image_shape: tuple, segs) -> np.ndarray:
    """Dense region mask in the reference's transposed (W, H) orientation
    (boundaries belong to the first pixel of the next region) — reference
    `dataset_construction.py:654-708`, computed on the CPU."""
    if len(image_shape) == 3:
        mask_shape = image_shape[:-1]  # channels_last
    else:
        mask_shape = image_shape
    image_width, image_height = mask_shape[0], mask_shape[1]
    segs = np.asarray(segs, dtype=np.float64)
    mask_hw = boundary_ops.create_area_mask(torch.from_numpy(segs), image_height).numpy()
    mask = mask_hw.T  # (W, H) orientation as the reference returns
    if len(image_shape) == 3:
        mask = np.expand_dims(mask, axis=-1)
    return mask


def mask_optic_nerve(mask, seg, onh):
    """Reference `:711-721`."""
    onh = np.squeeze(onh)
    seg = np.squeeze(seg)
    for x in range(onh[0], onh[1]):
        mask[x, : seg[0][x]] = 0
        mask[x, seg[0][x] :] = np.max(mask)
    return mask


def _roll_columns(image, offsets):
    """Per-column circular row shift in ONE gather (the vectorized form
    of the reference's per-column ``np.roll``):
    ``out[i, r, ...] = image[i, (r - offsets[i]) % H, ...]``."""
    h = image.shape[1]
    rows = (
        np.arange(h)[None, :] - np.asarray(offsets, dtype=np.int64)[:, None]
    ) % h
    idx = rows.reshape(rows.shape + (1,) * (image.ndim - 2))
    return np.take_along_axis(image, idx, axis=1)


def flatten_image_boundary(image, boundary, poly=False):
    """Column-roll flattening along a boundary — reference `:724-759`
    (one vectorized gather instead of W rolls; ``poly`` truncates each
    offset toward zero like the reference's ``int()``, exact because
    ``max(b) - b[i] >= 0``)."""
    num_cols = boundary.shape[0]
    if poly:
        coef = np.polyfit(np.arange(num_cols), boundary, deg=2)
        flatten_boundary = np.polyval(coef, np.arange(num_cols))
        offsets = (np.max(flatten_boundary) - flatten_boundary).astype(int)
    else:
        flatten_boundary = boundary
        offsets = np.max(boundary) - boundary
    return [
        _roll_columns(np.array(image), offsets),
        np.asarray(offsets),
        np.asarray(flatten_boundary),
    ]


def roll_image_offset(image, offset):
    """Reference `:762-769` (vectorized; negative offsets roll up)."""
    return _roll_columns(np.array(image), np.asarray(offset))
