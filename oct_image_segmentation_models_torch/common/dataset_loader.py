"""HDF5 dataset loaders, counterpart of the JAX package's
``common/dataset_loader.py``. They take an open :class:`.h5.File` (or
an ``h5py.File``) and return numpy arrays.

Dense per-pixel labels are read from ``{train,val,test}_labels``. When
only ``*_segs`` (boundary rows ``(N, num_boundaries, W)``) is present, the
dense labels are made from them with the area-mask convention (a
boundary belongs to the first pixel of the next region).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from ..ops.boundary import create_area_mask


def _labels_from_segs(segs: np.ndarray, image_height: int) -> np.ndarray:
    masks = create_area_mask(torch.from_numpy(np.asarray(segs, np.float32)), image_height)
    return masks.numpy()[..., None].astype(np.uint8)  # (N, H, W, 1)


def _load_split(hdf5_data_file, split: str, sample_slice: slice = None):
    """Load one split; ``sample_slice`` restricts the read to a subset of
    the samples at the HDF5 layer, so only those rows are read."""
    sel = slice(None) if sample_slice is None else sample_slice
    images = hdf5_data_file[f"{split}_images"][sel]
    if images.ndim == 3:
        images = images[..., None]
    labels_key = f"{split}_labels"
    segs_key = f"{split}_segs"
    if labels_key in hdf5_data_file:
        labels = hdf5_data_file[labels_key][sel]
        if labels.ndim == 3:
            labels = labels[..., None]
    elif segs_key in hdf5_data_file:
        labels = _labels_from_segs(hdf5_data_file[segs_key][sel], images.shape[1])
    else:
        raise KeyError(f"Dataset must contain '{labels_key}' or '{segs_key}'")
    return images, labels


def load_training_data(hdf5_data_file) -> Tuple[np.ndarray, np.ndarray]:
    return _load_split(hdf5_data_file, "train")


def load_validation_data(hdf5_data_file) -> Tuple[np.ndarray, np.ndarray]:
    return _load_split(hdf5_data_file, "val")


def _image_source_names(hdf5_data_file, n: int) -> List[Path]:
    """``test_images_source`` ascii paths when present, ``image_{i}``
    otherwise."""
    source = hdf5_data_file.get("test_images_source")
    if source is not None:
        return [Path(str(x, "ascii")) for x in source]
    return [Path(f"image_{i}") for i in range(n)]


def load_testing_data(hdf5_data_file) -> Tuple[np.ndarray, np.ndarray, List[Path]]:
    test_images, test_labels = _load_split(hdf5_data_file, "test")
    return (
        test_images,
        test_labels,
        _image_source_names(hdf5_data_file, len(test_images)),
    )


def load_prediction_images(hdf5_data_file) -> Tuple[np.ndarray, List[Path]]:
    """Images and source names of label-less prediction inputs: the
    ``test_images`` split or a bare ``images`` dataset; labels, if any,
    are ignored."""
    key = "test_images" if "test_images" in hdf5_data_file else "images"
    images = hdf5_data_file[key][:]
    if images.ndim == 3:
        images = images[..., None]
    return images, _image_source_names(hdf5_data_file, len(images))
