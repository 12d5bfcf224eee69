"""The port's plain min-path DP against the JAX ``_delineate_xla``, the
Pallas kernel in interpret mode and the heapq oracle: bit for bit (the DP
is integer arithmetic), in both tie modes."""

import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.ops import minpath as jm
from oct_image_segmentation_models_tpu.ops.minpath_pallas import delineate_pallas
from oct_image_segmentation_models_torch.ops import minpath as tm
from oct_image_segmentation_models_torch.ops.boundary import image_maps_to_s2d
from oct_image_segmentation_models_torch.ops.minpath_cuda import delineate_cuda

from oracle_minpath import dijkstra_delineate

# One shape for every family, so JAX compiles once per (max_grad, mode):
# 2 x 3 leading dims (batch x boundary), W = 24 columns, H = 20 rows (not
# a power of two).
LEAD, W, H = (2, 3), 24, 20
FAMILIES = ("ridge", "jumps", "gaps", "plateau", "flat_tail", "sparse", "dense")


def _smooth_rows(rng, w, h, max_step=1, margin=2):
    rows = [rng.integers(margin, h - margin)]
    for _ in range(w - 1):
        step = rng.integers(-max_step, max_step + 1)
        rows.append(int(np.clip(rows[-1] + step, margin, h - margin)))
    return np.array(rows)


def _ridge_map(w, h, rows):
    m = np.zeros((w, h), dtype=np.uint8)
    m[np.arange(w), rows] = 255
    return m


def _family_map(rng, family, w, h):
    """The map families of tests/test_minpath.py, one (W, H) map."""
    if family == "sparse":
        return (rng.random((w, h)) < 0.15).astype(np.uint8) * 255
    if family == "dense":
        return rng.integers(0, 256, size=(w, h), dtype=np.uint8)
    if family == "jumps":
        return _ridge_map(w, h, _smooth_rows(rng, w, h, max_step=4))
    m = _ridge_map(w, h, _smooth_rows(rng, w, h, max_step=2))
    if family == "gaps":
        m[rng.choice(w, size=6, replace=False), :] = 0
    elif family == "plateau":
        m |= np.roll(m, 1, axis=1)
        if rng.random() < 0.5:
            m |= np.roll(m, 2, axis=1)
    elif family == "flat_tail":
        tail = int(rng.integers(3, 9))
        if rng.random() < 0.5:
            m[-tail:, :] = 0
        else:
            m[:tail, :] = 0
    return m


def _family(seed, family, lead=LEAD, w=W, h=H):
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead))
    return np.stack([_family_map(rng, family, w, h) for _ in range(n)]).reshape(
        lead + (w, h)
    )


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
@pytest.mark.parametrize("max_grad", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_reference_matches_jax_xla(family, max_grad, tie_parity):
    maps = _family(FAMILIES.index(family) * 10 + max_grad, family)
    want = np.asarray(
        jm._delineate_xla(maps, max_grad=max_grad, tie_parity=tie_parity)
    )
    got = tm.delineate_reference(
        torch.from_numpy(maps), max_grad=max_grad, tie_parity=tie_parity
    )
    assert got.dtype == torch.int32 and got.shape == LEAD + (W,)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
def test_reference_matches_pallas_interpret(tie_parity):
    rng = np.random.default_rng(0)
    maps = np.stack(
        [
            (rng.random((12, 16)) < 0.3).astype(np.uint8) * 255,
            _ridge_map(12, 16, np.clip(8 + np.cumsum(rng.integers(-2, 3, 12)), 1, 14)),
        ]
    )
    want = np.asarray(delineate_pallas(maps, interpret=True, tie_parity=tie_parity))
    got = tm.delineate_reference(torch.from_numpy(maps), tie_parity=tie_parity)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("family", ["ridge", "jumps", "flat_tail", "sparse"])
def test_reference_exact_matches_oracle(family):
    maps = _family(100 + FAMILIES.index(family), family, lead=(3,))
    got = tm.delineate_reference(torch.from_numpy(maps), tie_parity="exact")
    for i in range(maps.shape[0]):
        assert np.array_equal(got[i].numpy(), dijkstra_delineate(maps[i]))


def test_delineate_image_maps_matches_jax():
    maps_img = np.swapaxes(_family(7, "plateau"), -1, -2).copy()
    for tie in ("exact", "fast"):
        want = np.asarray(
            jm.delineate_image_maps(maps_img, tie_parity=tie, backend="xla")
        )
        got = tm.delineate_image_maps(torch.from_numpy(maps_img), tie_parity=tie)
        assert np.array_equal(got.numpy(), want)


def test_validate_and_calc_errors_match_jax():
    for g in (0, 1, 2, 7, 30):
        assert tm.validate_max_grad_packing(g) == jm.validate_max_grad_packing(g)
    with pytest.raises(ValueError, match="max_grad <= 30"):
        tm.validate_max_grad_packing(31)
    pred = np.array([5, 6, 7, 8], dtype=np.uint16)
    truth = np.array([5.0, np.nan, 0.0, 10.0], dtype=np.float32)
    want = np.asarray(jm.calc_errors(pred, truth))
    got = tm.calc_errors(torch.from_numpy(pred), torch.from_numpy(truth)).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want, equal_nan=True)


def test_dispatch_on_cpu():
    maps = torch.from_numpy(_family(9, "ridge", lead=(2,)))
    ref = tm.delineate_reference(maps)
    assert torch.equal(tm.delineate(maps), ref)  # "auto" on a CPU tensor
    assert torch.equal(tm.delineate(maps, backend="reference"), ref)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tm.delineate(maps, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        delineate_cuda(maps)
    with pytest.raises(ValueError, match="unknown backend"):
        tm.delineate(maps, backend="xla")
    with pytest.raises(ValueError, match="tie_parity"):
        tm.delineate_reference(maps, tie_parity="heap")


def _to_s2d(maps_img):
    """Image maps (B, M, H, W) -> s2d maps (B, M, H/2, W/2, 4), numpy."""
    return image_maps_to_s2d(torch.from_numpy(maps_img)).numpy()


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
def test_s2d_reference_matches_pallas_s2d_interpret(tie_parity):
    from oct_image_segmentation_models_tpu.ops.minpath_pallas import (
        delineate_pallas_s2d,
    )

    rng = np.random.default_rng(7)
    for b, m_n, h, w, g in [(2, 3, 16, 12, 1), (1, 2, 32, 20, 2)]:
        maps = rng.integers(0, 256, (b, m_n, h, w), dtype=np.uint8)
        maps[0, 0] = _ridge_map(w, h, _smooth_rows(rng, w, h)).T  # a tie-rich map
        s2d = _to_s2d(maps)
        want = np.asarray(
            delineate_pallas_s2d(s2d, max_grad=g, interpret=True, tie_parity=tie_parity)
        )
        got = tm.delineate_s2d_reference(
            torch.from_numpy(s2d), max_grad=g, tie_parity=tie_parity
        )
        assert got.dtype == torch.int32 and got.shape == (b, m_n, w)
        assert np.array_equal(got.numpy(), want)
        # The same rows as the plain DP on the transposed image maps.
        plain = tm.delineate_reference(
            torch.from_numpy(np.swapaxes(maps, -1, -2).copy()),
            max_grad=g,
            tie_parity=tie_parity,
        )
        assert torch.equal(got, plain)


def test_s2d_dispatch_on_cpu():
    from oct_image_segmentation_models_torch.ops.minpath_cuda import delineate_cuda_s2d

    s2d = torch.from_numpy(_to_s2d(np.swapaxes(_family(3, "plateau"), -1, -2).copy()))
    ref = tm.delineate_s2d_reference(s2d)
    assert torch.equal(tm.delineate_s2d(s2d), ref)  # "auto" on a CPU tensor
    assert torch.equal(tm.delineate_s2d(s2d, backend="reference"), ref)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tm.delineate_s2d(s2d, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        delineate_cuda_s2d(s2d)
