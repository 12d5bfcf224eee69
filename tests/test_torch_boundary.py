"""The port's boundary-map ops against the JAX ``ops/boundary.py``, bit for
bit (every output is an integer or an exact float one-hot)."""

import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.ops import boundary as jb
from oct_image_segmentation_models_torch.ops import boundary as tb

from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)


def _labels(rng, b=3, h=20, w=17, c=4):
    """Layered labels with random boundaries, plus salt noise."""
    rows = np.arange(h)[:, None]
    out = np.zeros((b, h, w), np.int64)
    for i in range(b):
        bounds = np.sort(rng.integers(1, h - 1, size=(c - 1, w)), axis=0)
        out[i] = (rows[None] >= bounds[:, None, :]).sum(0)
    noise = rng.random(out.shape) < 0.05
    out[noise] = rng.integers(0, c, size=int(noise.sum()))
    return out


def _probs(rng, labels, c):
    """Softmax-like probabilities whose argmax is ``labels`` and with exact
    ties on some pixels (first index must win)."""
    p = rng.random(labels.shape + (c,)).astype(np.float32) * 0.5
    np.put_along_axis(p, labels[..., None], 0.9, axis=-1)
    tie = rng.random(labels.shape) < 0.1
    p[tie] = 0.25
    return p


def test_to_categorical_matches_jax():
    rng = np.random.default_rng(0)
    lab = rng.integers(-1, 5, size=(2, 6, 5, 1))  # out-of-range labels too
    want = np.asarray(jb.to_categorical(lab, 4))
    got = tb.to_categorical(torch.from_numpy(lab), 4).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("bin", [True, False])
def test_perform_argmax_with_ties_matches_jax(bin):
    rng = np.random.default_rng(1)
    probs = _probs(rng, _labels(rng), 4)
    ja, jc = jb.perform_argmax(probs, bin=bin)
    ta, tc = tb.perform_argmax(torch.from_numpy(probs), bin=bin)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize(
    "bg_ilm,bg_csi", [(True, False), (False, False), (True, True), (False, True)]
)
def test_boundary_prob_maps_matches_jax(bg_ilm, bg_csi):
    rng = np.random.default_rng(2)
    lab = _labels(rng, c=5)
    _, cat = jb.perform_argmax(_probs(rng, lab, 5))
    want = np.asarray(jb.boundary_prob_maps(cat, bg_ilm=bg_ilm, bg_csi=bg_csi))
    got = tb.boundary_prob_maps(
        torch.from_numpy(np.array(cat)), bg_ilm=bg_ilm, bg_csi=bg_csi
    ).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_boundary_maps_wrap_two_to_254():
    # Class 1 on row 1 only: the one-sided difference at row 0 is 1.0, so
    # the ridge there is 2.0, and 2.0 * 255 = 510 wraps to 254.
    lab = np.full((1, 8, 3), 2, np.int64)
    lab[0, 0, :] = 0
    lab[0, 1, :] = 1
    cat = np.asarray(jb.to_categorical(lab, 3)).transpose(0, 3, 1, 2)
    want = np.asarray(jb.boundary_prob_maps(cat, bg_ilm=False))
    got = tb.boundary_prob_maps(torch.from_numpy(cat), bg_ilm=False).numpy()
    assert np.array_equal(got, want)
    assert 254 in got
    ints = tb.boundary_maps_from_labels(torch.from_numpy(lab), 3, bg_ilm=False)
    assert np.array_equal(ints.numpy(), want)


@pytest.mark.parametrize("bg_ilm,bg_csi", [(True, False), (False, True)])
def test_boundary_maps_from_labels_matches_jax(bg_ilm, bg_csi):
    rng = np.random.default_rng(3)
    lab = _labels(rng, c=4).astype(np.int32)
    want = np.asarray(
        jb.boundary_maps_from_labels(lab, 4, bg_ilm=bg_ilm, bg_csi=bg_csi)
    )
    got = tb.boundary_maps_from_labels(
        torch.from_numpy(lab), 4, bg_ilm=bg_ilm, bg_csi=bg_csi
    ).numpy()
    assert np.array_equal(got, want)
    # The integer path equals the float one-hot path.
    cat = tb.to_categorical(torch.from_numpy(lab), 4).permute(0, 3, 1, 2)
    assert np.array_equal(
        tb.boundary_prob_maps(cat, bg_ilm=bg_ilm, bg_csi=bg_csi).numpy(), got
    )


def _segs():
    """Boundary rows with NaN and 0 entries to repair, and columns whose
    repaired boundaries come out of order."""
    return np.array(
        [
            [
                [5.0, np.nan, 0.0, 9.0, 12.0, np.nan],
                [8.0, 7.0, 3.0, 0.0, 4.0, np.nan],
                [11.0, 2.0, np.nan, 14.0, 15.0, 6.0],
            ],
            [
                [0.0, 1.0, 2.0, 3.0, 4.0, 5.0],
                [np.nan, np.nan, np.nan, np.nan, np.nan, np.nan],
                [10.0, 0.0, 12.0, 13.0, 1.0, 15.0],
            ],
        ],
        np.float32,
    )


def test_repair_segs_matches_jax():
    segs = _segs()
    want = np.asarray(jb.repair_segs(segs, 16))
    got = tb.repair_segs(torch.from_numpy(segs), 16).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_create_area_mask_matches_jax(dtype):
    segs = _segs()
    if dtype == np.int32:
        segs = np.nan_to_num(segs).astype(np.int32)
    want = np.asarray(jb.create_area_mask(segs, 16))
    got = tb.create_area_mask(torch.from_numpy(segs), 16).numpy()
    assert got.dtype == np.uint8 and got.shape == (2, 16, 6)
    assert np.array_equal(got, want)


def _s2d_labels(rng, b=2, h=20, w=18, c=4):
    """(B, H/2, W/2, 4) s2d labels, channels (q_h, q_w), of layered labels."""
    lab = _labels(rng, b=b, h=h, w=w, c=c)
    return lab.reshape(b, h // 2, 2, w // 2, 2).transpose(0, 1, 3, 2, 4).reshape(
        b, h // 2, w // 2, 4
    )


@pytest.mark.parametrize("transposed", [False, True, "s2d"])
@pytest.mark.parametrize(
    "bg_ilm,bg_csi", [(True, False), (False, False), (True, True), (False, True)]
)
def test_boundary_maps_from_s2d_labels_matches_jax(bg_ilm, bg_csi, transposed):
    rng = np.random.default_rng(11)
    lab = _s2d_labels(rng, c=5).astype(np.uint8)
    want = np.asarray(
        jb.boundary_maps_from_s2d_labels(
            lab, 5, bg_ilm=bg_ilm, bg_csi=bg_csi, transposed=transposed
        )
    )
    got = tb.boundary_maps_from_s2d_labels(
        torch.from_numpy(lab), 5, bg_ilm=bg_ilm, bg_csi=bg_csi, transposed=transposed
    ).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_s2d_maps_match_image_maps_and_wrap():
    # Class 1 on row 1 only: the ridge at row 0 is 2, which wraps to 254;
    # the last block row exercises the np.roll wrap.
    lab = np.full((1, 8, 6), 2, np.int64)
    lab[0, 0, :] = 0
    lab[0, 1, :] = 1
    lab[0, 7, :] = 1
    s2d = lab.reshape(1, 4, 2, 3, 2).transpose(0, 1, 3, 2, 4).reshape(1, 4, 3, 4)
    want = np.asarray(jb.boundary_maps_from_s2d_labels(s2d, 3, bg_ilm=False))
    got = tb.boundary_maps_from_s2d_labels(torch.from_numpy(s2d), 3, bg_ilm=False)
    assert np.array_equal(got.numpy(), want) and 254 in want
    assert torch.equal(got, tb.boundary_maps_from_labels(torch.from_numpy(lab), 3, bg_ilm=False))


def test_s2d_map_layouts_match_jax():
    rng = np.random.default_rng(12)
    m = rng.integers(0, 256, (2, 3, 5, 4, 4), dtype=np.uint8)
    for name in ("s2d_maps_to_image", "s2d_maps_to_transposed"):
        want = np.asarray(getattr(jb, name)(m))
        got = getattr(tb, name)(torch.from_numpy(m)).numpy()
        assert np.array_equal(got, want), name


def test_image_maps_to_s2d_inverts_s2d_maps_to_image():
    rng = np.random.default_rng(13)
    m = torch.from_numpy(rng.integers(0, 256, (2, 3, 5, 4, 4), dtype=np.uint8))
    img = tb.s2d_maps_to_image(m)
    back = tb.image_maps_to_s2d(img)
    assert back.is_contiguous() and torch.equal(back, m)
    # Map value at (row i, column j) sits at [i // 2, j // 2, 2 (i % 2) + j % 2].
    assert int(back[1, 2, 3, 1, 2]) == int(img[1, 2, 7, 2])
