"""The port's graph-search API against the JAX package's, on the same
inputs (the cases of tests/test_graph_search_api.py).

- ``segment_maps`` on uint8 maps and on integer-valued float maps: rows
  bit-equal to JAX's (exact ties), max_grad 1 and 2, on ridge, plateau
  and sparse maps;
- non-quantized float maps with ``float_map_backend="device"``: rows
  equal to JAX ``delineate_float`` on the CPU, and ``delineate_float``
  itself equal to JAX's, ties included;
- ``"host"`` float maps and vertical graphs (the host Dijkstra): equal
  to JAX;
- ``calc_errors`` and ``calculate_overall_errors``: equal within 1e-12,
  with NaN in the same places.
"""

import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.min_path_processing import (
    generate_boundary as jax_generate_boundary,
)
from oct_image_segmentation_models_tpu.min_path_processing import (
    graph_search as jgs,
)
from oct_image_segmentation_models_tpu.ops import minpath as jax_minpath
from oct_image_segmentation_models_torch.min_path_processing import (
    generate_boundary,
    graph_search as tgs,
)
from oct_image_segmentation_models_torch.ops import minpath as torch_minpath

from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

ERR_ATOL = 1e-12


def _maps(rng, family, n, w, h):
    """``(n, w, h)`` uint8 maps: one-row ridges, 2-row plateau ridges or
    sparse random 0/255."""
    if family == "sparse":
        return (rng.random((n, w, h)) < 0.2).astype(np.uint8) * 255
    rows = np.clip(h // 2 + np.cumsum(rng.integers(-1, 2, (n, w)), 1), 1, h - 2)
    m = np.zeros((n, w, h), np.uint8)
    m[np.arange(n)[:, None], np.arange(w)[None, :], rows] = 255
    if family == "plateau":
        m |= np.roll(m, 1, axis=2)
    return m


def _truths(rng, n, w, h):
    truths = rng.integers(0, h, (n, w)).astype(np.float64)
    truths[0, 3] = np.nan
    truths[-1, 5] = 0
    return truths


def _assert_errors_equal(got, want):
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=ERR_ATOL)


@pytest.mark.parametrize("as_float", [False, True], ids=["uint8", "int_float"])
@pytest.mark.parametrize("max_grad", [1, 2])
@pytest.mark.parametrize("family", ["ridge", "plateau", "sparse"])
def test_segment_maps_integer_maps_match_jax(family, max_grad, as_float):
    rng = np.random.default_rng(max_grad * 10 + len(family))
    w, h = 24, 16
    maps = _maps(rng, family, 3, w, h)
    if as_float:
        maps = maps.astype(np.float64)
    truths = _truths(rng, 3, w, h)
    gs_j = jgs.create_graph_structure((w, h), max_grad=max_grad)
    gs_t = tgs.create_graph_structure((w, h), max_grad=max_grad)
    assert (gs_t.graph_width, gs_t.graph_height) == (gs_j.graph_width, gs_j.graph_height)
    want_rows, want_err, want_norm = jgs.segment_maps(maps, truths, gs_j)
    got_rows, got_err, got_norm = tgs.segment_maps(maps, truths, gs_t, device="cpu")
    assert got_rows.dtype == np.uint16
    np.testing.assert_array_equal(got_rows, want_rows)
    _assert_errors_equal(got_err, want_err)
    np.testing.assert_array_equal(got_norm, want_norm)


def _float_maps(rng, n, w, h):
    """Ridge maps with Gaussian noise, on the 0..255 scale, off the
    uint8 grid."""
    ridge = _maps(rng, "ridge", n, w, h) / 255.0
    return np.clip(ridge + rng.normal(0, 0.05, (n, w, h)), 0, 1) * 255.0


@pytest.mark.parametrize("max_grad", [1, 2])
def test_segment_maps_float_device_matches_jax(max_grad):
    rng = np.random.default_rng(20 + max_grad)
    w, h = 30, 18
    maps = _float_maps(rng, 4, w, h)
    gs_j = jgs.create_graph_structure((w, h), max_grad=max_grad)
    want, _, _ = jgs.segment_maps(maps, None, gs_j)
    got, err, _ = tgs.segment_maps(
        maps, None, tgs.create_graph_structure((w, h), max_grad=max_grad), device="cpu"
    )
    np.testing.assert_array_equal(got, want)
    assert not err.any()  # no truths, zero errors, as in JAX


@pytest.mark.parametrize(
    "kind,max_grad",
    [("noisy", 1), ("noisy", 3), ("plateau", 1), ("constant", 2)],
)
def test_delineate_float_matches_jax(kind, max_grad):
    """Ties resolve to the same candidate: on plateau maps many paths tie,
    on constant maps every candidate of every column ties."""
    rng = np.random.default_rng(max_grad)
    n, w, h = 5, 40, 21
    if kind == "noisy":
        maps = _float_maps(rng, n, w, h) / 255.0
    elif kind == "plateau":
        maps = _maps(rng, "plateau", n, w, h) * np.float64(0.7 / 255.0)
    else:
        maps = np.full((n, w, h), 0.3)
    maps = maps.astype(np.float32)
    want = np.asarray(jax_minpath.delineate_float(maps, max_grad=max_grad))
    got = torch_minpath.delineate_float(torch.from_numpy(maps), max_grad=max_grad)
    assert got.dtype == torch.int32 and got.shape == (n, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_maps_float_host_and_vertical_match_jax():
    rng = np.random.default_rng(7)
    w, h = 12, 9
    maps = _float_maps(rng, 2, w, h)
    gs_j = jgs.create_graph_structure((w, h))
    gs_t = tgs.create_graph_structure((w, h))
    want, _, _ = jgs.segment_maps(maps, None, gs_j, float_map_backend="host")
    got, _, _ = tgs.segment_maps(maps, None, gs_t, float_map_backend="host", device="cpu")
    np.testing.assert_array_equal(got, want)

    ridge = _maps(rng, "ridge", 2, w, h).astype(np.float64)
    vj = jgs.create_graph_structure_vertical((w, h))
    vt = tgs.create_graph_structure_vertical((w, h))
    want_v, _, _ = jgs.segment_maps(ridge, None, vj)
    got_v, _, _ = tgs.segment_maps(ridge, None, vt, device="cpu")
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(
        tgs.delineate_boundary_vertical(maps[0] / 255.0, vt),
        jgs.delineate_boundary_vertical(maps[0] / 255.0, vj),
    )
    np.testing.assert_array_equal(
        tgs.delineate_boundary(ridge[0] / 255.0, gs_t, device="cpu"),
        jgs.delineate_boundary(ridge[0] / 255.0, gs_j),
    )
    padded = jgs.append_firstlast_cols(maps[0] / 255.0)
    np.testing.assert_array_equal(tgs.append_firstlast_cols(maps[0] / 255.0), padded)
    assert tgs.run_dijkstras(padded, 0, gs_t) == jgs.run_dijkstras(padded, 0, gs_j)
    with pytest.raises(ValueError, match="float_map_backend"):
        tgs.segment_maps(maps, None, gs_t, float_map_backend="banana", device="cpu")


def test_calc_errors_and_overall_errors_match_jax():
    rng = np.random.default_rng(3)
    preds = rng.integers(0, 40, (3, 50)).astype(np.uint16)
    truths = rng.integers(0, 40, (3, 50)).astype(np.float64)
    truths[0, :7] = np.nan
    truths[1, 10:12] = 0
    truths[2, :] = np.nan  # a boundary with no valid column at all
    got = np.stack([tgs.calc_errors(preds[m], truths[m]) for m in range(3)])
    want = np.stack([jgs.calc_errors(preds[m], truths[m]) for m in range(3)])
    _assert_errors_equal(got, want)
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        overall_t = tgs.calculate_overall_errors(got)
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        overall_j = jgs.calculate_overall_errors(want)
    assert len(overall_t) == len(overall_j) == 4
    for a, b in zip(overall_t, overall_j):
        _assert_errors_equal(a, b)
    labels = rng.integers(0, 4, (10, 7))
    np.testing.assert_array_equal(
        generate_boundary(labels, axis=0), jax_generate_boundary(labels, axis=0)
    )


def test_graph_search_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; device=None resolves to it")
    gs = tgs.create_graph_structure((6, 5))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgs.segment_maps(np.zeros((1, 6, 5), np.uint8), None, gs)
