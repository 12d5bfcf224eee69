"""Surface-distance metrics (average symmetric surface distance, robust
Hausdorff) for 2-D binary masks: the port's own copy of the JAX package's
``common/surface_distance.py`` (numpy and scipy).

The original system uses DeepMind's ``surface-distance`` package with
spacing ``(0.01111111, 0.01111111)`` and the 95th-percentile Hausdorff;
this module reimplements its 2-D algorithm exactly:

- each 2x2 pixel cell gets a 4-bit *neighbour code* (correlation with the
  kernel ``[[8, 4], [2, 1]]``, zero-padded); cells that are neither empty
  (0) nor full (15) are *border cells*;
- a marching-squares lookup table maps each code to the contour length
  crossing that cell (axis lengths from ``spacing_mm``, diagonals
  ``0.5 * hypot(dy, dx)``) — the per-element weight;
- distances between the two border-cell sets come from a Euclidean
  distance transform (anisotropic via ``spacing_mm``);
- the average surface distance is the contour-length-weighted mean and
  the robust Hausdorff a contour-length-weighted percentile (cumulative
  weights, ``searchsorted``);
- empty masks follow DeepMind's exact (asymmetric) conventions: the
  average surface distance is ``nan`` (their unguarded weighted mean is
  0/0 there) while the robust Hausdorff is ``inf`` (their explicit
  empty-case return); the evaluation aggregation treats both as missing
  (`evaluation/evaluation.py` maps inf to NaN before nanmean).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy import ndimage

# Bit layout of a cell code (kernel [[8,4],[2,1]] correlated with the
# mask): 8 = top-left, 4 = top-right, 2 = bottom-left, 1 = bottom-right.
_ENCODE_KERNEL_2D = np.array([[8, 4], [2, 1]])
_FULL_CODE_2D = 0b1111


def _contour_length_table(spacing_mm: Tuple[float, ...]) -> np.ndarray:
    """Marching-squares contour length per neighbour code (DeepMind's
    ``create_table_neighbour_code_to_contour_length``)."""
    vertical, horizontal = float(spacing_mm[0]), float(spacing_mm[1])
    diag = 0.5 * math.hypot(vertical, horizontal)
    table = np.zeros(16)
    # Single corner inside: one diagonal cut.
    for code in (0b0001, 0b0010, 0b0100, 0b1000):
        table[code] = diag
    # Single corner outside: complementary single diagonal cut.
    for code in (0b1110, 0b1101, 0b1011, 0b0111):
        table[code] = diag
    # Two horizontally-adjacent corners: a horizontal contour segment.
    table[0b0011] = horizontal
    table[0b1100] = horizontal
    # Two vertically-adjacent corners: a vertical contour segment.
    table[0b0101] = vertical
    table[0b1010] = vertical
    # Diagonal pairs (saddles): two diagonal cuts.
    table[0b0110] = 2 * diag
    table[0b1001] = 2 * diag
    return table


def _sort_by_distance(distances: np.ndarray, areas: np.ndarray):
    order = np.argsort(distances, kind="stable")
    return distances[order], areas[order]


def compute_surface_distances(
    mask_gt: np.ndarray, mask_pred: np.ndarray, spacing_mm: Tuple[float, ...]
) -> dict:
    """Distances (and contour-length weights) from each ground-truth
    border cell to the prediction border and vice versa."""
    mask_gt = np.asarray(mask_gt).astype(np.uint8)
    mask_pred = np.asarray(mask_pred).astype(np.uint8)
    table = _contour_length_table(spacing_mm)

    codes_gt = ndimage.correlate(
        mask_gt, _ENCODE_KERNEL_2D, mode="constant", cval=0
    )
    codes_pred = ndimage.correlate(
        mask_pred, _ENCODE_KERNEL_2D, mode="constant", cval=0
    )
    borders_gt = (codes_gt != 0) & (codes_gt != _FULL_CODE_2D)
    borders_pred = (codes_pred != 0) & (codes_pred != _FULL_CODE_2D)

    if borders_gt.any():
        distmap_gt = ndimage.distance_transform_edt(
            ~borders_gt, sampling=spacing_mm
        )
    else:
        distmap_gt = np.full(borders_gt.shape, np.inf)
    if borders_pred.any():
        distmap_pred = ndimage.distance_transform_edt(
            ~borders_pred, sampling=spacing_mm
        )
    else:
        distmap_pred = np.full(borders_pred.shape, np.inf)

    distances_gt_to_pred = distmap_pred[borders_gt]
    distances_pred_to_gt = distmap_gt[borders_pred]
    surfel_areas_gt = table[codes_gt[borders_gt]]
    surfel_areas_pred = table[codes_pred[borders_pred]]

    # Sorted by distance: the weighted percentile below walks the
    # cumulative contour length in distance order.
    distances_gt_to_pred, surfel_areas_gt = _sort_by_distance(
        distances_gt_to_pred, surfel_areas_gt
    )
    distances_pred_to_gt, surfel_areas_pred = _sort_by_distance(
        distances_pred_to_gt, surfel_areas_pred
    )

    return {
        "distances_gt_to_pred": distances_gt_to_pred,
        "distances_pred_to_gt": distances_pred_to_gt,
        "surfel_areas_gt": surfel_areas_gt,
        "surfel_areas_pred": surfel_areas_pred,
    }


def compute_average_surface_distance(surface_distances: dict):
    """Contour-length-weighted mean distance, each direction separately."""
    d_gt = surface_distances["distances_gt_to_pred"]
    d_pred = surface_distances["distances_pred_to_gt"]
    w_gt = surface_distances["surfel_areas_gt"]
    w_pred = surface_distances["surfel_areas_pred"]
    # Empty surface -> nan, exactly like DeepMind's implementation
    # (whose unguarded sum(d*w)/sum(w) is 0/0 there); its robust
    # Hausdorff, by contrast, explicitly returns inf for the empty case
    # — the asymmetry is theirs and is reproduced here.
    avg_gt_to_pred = (
        np.sum(d_gt * w_gt) / np.sum(w_gt) if d_gt.size else np.nan
    )
    avg_pred_to_gt = (
        np.sum(d_pred * w_pred) / np.sum(w_pred) if d_pred.size else np.nan
    )
    return avg_gt_to_pred, avg_pred_to_gt


def compute_robust_hausdorff(surface_distances: dict, percent: float) -> float:
    """Contour-length-weighted percentile of the symmetric distances."""

    def _weighted_percentile(distances, areas):
        if not distances.size:
            return np.inf
        cum = np.cumsum(areas) / np.sum(areas)
        idx = np.searchsorted(cum, percent / 100.0)
        return distances[min(idx, len(distances) - 1)]

    h_gt = _weighted_percentile(
        surface_distances["distances_gt_to_pred"],
        surface_distances["surfel_areas_gt"],
    )
    h_pred = _weighted_percentile(
        surface_distances["distances_pred_to_gt"],
        surface_distances["surfel_areas_pred"],
    )
    return max(h_gt, h_pred)


def average_surface_distance(
    y_true: np.ndarray, y_pred: np.ndarray, spacing: Tuple[float, ...]
):
    """Average surface distance in each direction, as the original
    system's `common/custom_metrics.py` API."""
    return compute_average_surface_distance(
        compute_surface_distances(y_true, y_pred, spacing)
    )


def hausdorff_distance(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    spacing: Tuple[float, ...],
    percent: float,
) -> float:
    """Robust Hausdorff distance at `percent`, as the original system's
    `common/custom_metrics.py` API."""
    return compute_robust_hausdorff(
        compute_surface_distances(y_true, y_pred, spacing), percent
    )
