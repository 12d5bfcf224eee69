"""The port's ``common/dataset_construction.py`` (a numpy copy) and
``common/profiling.py::DeviceStopwatch`` against the JAX package's.

Each function of the dataset tooling runs on the same seeded inputs in
both packages (random draws from a ``default_rng`` of the same seed), and
the outputs must be equal; ``construct_dataset``'s written files must hold
the same datasets and attributes, the write time and timestamp apart.
"""

import time

import h5py
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.common import dataset_construction as jax_dc
from oct_image_segmentation_models_tpu.common.profiling import (
    DeviceStopwatch as JaxDeviceStopwatch,
)
from oct_image_segmentation_models_torch.common import dataset_construction as dc
from oct_image_segmentation_models_torch.common.profiling import DeviceStopwatch

from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

W_IMG, H_IMG, NB = 20, 40, 3
RUN_ATTRS = {"construct_time", "timestamp"}


def _image_and_segs(seed):
    """A ``(W, H, 1)`` image and ``(NB, W)`` boundary rows, ordered and
    apart by at least 4, in the reference's orientation."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (W_IMG, H_IMG, 1), dtype=np.uint8)
    base = np.sort(rng.choice(np.arange(6, H_IMG - 6, 8), NB, replace=False))
    segs = base[:, None] + rng.integers(-1, 2, (NB, W_IMG))
    return image, segs.astype(np.int64)


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bg_mode,bg_margin", [("single", 0), ("extra", 2)])
def test_patch_labels(bg_mode, bg_margin):
    image, segs = _image_and_segs(1)
    segs = segs.astype(np.float64)
    segs[1, 3] = np.nan  # an invalid column
    for fn, args in (
        ("create_patch_labels", (image, segs, bg_mode, bg_margin)),
        ("create_all_patch_labels", (image[None], segs[None], bg_mode, bg_margin)),
    ):
        _equal(getattr(dc, fn)(*args), getattr(jax_dc, fn)(*args))


@pytest.mark.parametrize(
    "bg_mode,bg_margin,bg_splits",
    [("single", 0, None), ("three", 1, None), ("all", 0, None), ("extra", 2, None),
     ("super", 2, [2, 1, 1, 2])],
)
def test_sample_training_patches(bg_mode, bg_margin, bg_splits):
    image, segs = _image_and_segs(2)
    args = (image, segs, range(2, W_IMG - 2), (8, 6), bg_mode, bg_margin, bg_splits)
    got = dc.sample_training_patches(*args, rng=np.random.default_rng(5))
    want = jax_dc.sample_training_patches(*args, rng=np.random.default_rng(5))
    _equal(got, want)
    # unseeded draws: the labels and shapes agree
    got = dc.sample_all_training_patches(image[None], segs[None], *args[2:])
    want = jax_dc.sample_all_training_patches(image[None], segs[None], *args[2:])
    assert got[0].shape == want[0].shape
    _equal(got[1], want[1])


def test_patches_and_geometry_helpers():
    image, segs = _image_and_segs(3)
    labels = dc.create_patch_labels(image, segs)
    for fn, args in (
        ("pad_patch_image", (image, (7, 4))),
        ("construct_patch", (dc.pad_patch_image(image, (7, 4)), 3, 5, (7, 4))),
        ("choose_bg_ind", (4, segs, 0, H_IMG)),
        ("create_area_mask", (image.shape, segs)),
        ("create_area_mask", (image.shape[:2], segs)),
        ("mask_optic_nerve", (dc.create_area_mask(image.shape[:2], segs), segs[:2] + 1,
                              np.array([[3, 9]]))),
        ("flatten_image_boundary", (image, segs[0].astype(np.float64))),
        ("flatten_image_boundary", (image, segs[1].astype(np.float64), True)),
        ("roll_image_offset", (image, np.arange(W_IMG) - 7)),
    ):
        def kwargs():
            return {"rng": np.random.default_rng(1)} if fn == "choose_bg_ind" else {}

        _equal(getattr(dc, fn)(*args, **kwargs()), getattr(jax_dc, fn)(*args, **kwargs()))
    got = dc.construct_patches_whole_image(image[:6, :5], labels[:6, :5], (4, 4))
    want = jax_dc.construct_patches_whole_image(image[:6, :5], labels[:6, :5], (4, 4))
    _equal(got[:2], want[:2])


def _h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = {k: np.asarray(v) for k, v in f.attrs.items() if k not in RUN_ATTRS}
        f.visititems(lambda k, o: out.__setitem__(k, np.asarray(o[()])))
    return out


@pytest.mark.parametrize("patches", [False, True])
def test_construct_dataset_writes_jax_file(tmp_path, patches):
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (3, W_IMG, H_IMG), dtype=np.uint8)
    segs = np.stack([_image_and_segs(s)[1] for s in range(3)]).astype(np.uint16)
    labels = rng.integers(0, NB + 1, (3, W_IMG, H_IMG), dtype=np.uint8)
    if patches:
        labels = rng.integers(0, NB + 1, (9,), dtype=np.uint8)
        images = rng.integers(0, 256, (9, 8, 6, 1), dtype=np.uint8)
    names = {
        "boundary_names": [b"ILM", b"RPE", b"BM"],
        "area_names": [b"a", b"b", b"c", b"d"],
        "patch_class_names": [b"bg", b"ILM"],
        "fullsize_class_names": [b"a", b"b", b"c", b"d"],
        "image_names": [f"img_{i}".encode() for i in range(len(images))],
    }
    written = {}
    for side, fn in (("torch", dc.construct_dataset), ("jax", jax_dc.construct_dataset)):
        (tmp_path / side).mkdir()
        written[side] = fn(
            images, labels, None if patches else segs, "octset", "train",
            names["boundary_names"], names["area_names"], names["patch_class_names"],
            None if patches else names["fullsize_class_names"], names["image_names"],
            time.time(), patches, None if patches else labels, range(2, 18), (8, 6), NB,
            NB + 1, 1, "channels_last", "wh", f"{tmp_path / side}/", bg_mode="single",
        )
    assert written["torch"].replace("/torch/", "/jax/") == written["jax"]
    got, want = _h5(written["torch"]), _h5(written["jax"])
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "/":
            assert sorted(got[key]) == sorted(want[key])
            for a in want[key]:
                _equal(got[key][a], want[key][a])
        else:
            _equal(got[key], want[key])


def test_device_stopwatch_surface():
    """``start(value)`` / ``stop(value) -> seconds`` as JAX's; on the CPU it
    reads the host clock, and without a card ``device=None`` raises."""
    x = torch.randn(256, 256)
    for sw in (DeviceStopwatch("cpu"), JaxDeviceStopwatch()):
        sw.start(x)
        y = x @ x
        time.sleep(0.01)
        assert 0.01 <= sw.stop(y) < 5
    assert DeviceStopwatch("cpu").device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceStopwatch()
