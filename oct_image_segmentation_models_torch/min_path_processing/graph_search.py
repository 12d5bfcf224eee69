"""Graph-search (min-path) public API, counterpart of the JAX package's
``min_path_processing/graph_search.py``.

``create_graph_structure`` returns a small :class:`GraphStructure`
descriptor (shape, max_grad, direction), not per-vertex adjacency lists:
the column DP needs nothing more. ``segment_maps`` and
``delineate_boundary`` run standard graphs on uint8 maps, and on float
maps on the uint8/255 grid, through :func:`..ops.minpath.delineate`, the
CUDA kernel ``minpath_delineate`` on the card, bit-equal to the heap
Dijkstra of the original system. Other float maps take the float column
DP (:func:`..ops.minpath.delineate_float`) or, on request, the exact host
Dijkstra (``run_dijkstras``), which is also the only route for vertical
graphs: their upward moves make the graph cyclic.

The functions take and return numpy arrays; those that run the DP take
``device`` (None means CUDA).
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..ops import minpath as minpath_ops

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class GraphStructure:
    """Descriptor of the gridded min-path graph.

    ``shape`` is the (width, height) of the unpadded probability map; two
    all-ones virtual columns are implied.
    """

    shape: tuple
    max_grad: int = 1
    vertical: bool = False

    @property
    def graph_width(self):
        return self.shape[0] + 2

    @property
    def graph_height(self):
        return self.shape[1]


def create_graph_structure(shape, max_grad=1) -> GraphStructure:
    return GraphStructure(shape=tuple(shape[:2]), max_grad=max_grad)


def create_graph_structure_vertical(shape) -> GraphStructure:
    """The graph with up and down moves inside the real columns."""
    return GraphStructure(shape=tuple(shape[:2]), max_grad=1, vertical=True)


def append_firstlast_cols(prob_map):
    """Append the all-ones first and last columns."""
    map_height = prob_map.shape[1]
    return np.concatenate(
        [np.ones((1, map_height)), prob_map, np.ones((1, map_height))], axis=0
    )


def _neighbours(j, i, w, h, g, vertical):
    """Neighbour list of graph node (col j, row i) in the original
    system's construction order."""
    right = (j + 1, i)
    down = (j, i + 1)
    up = (j, i - 1)
    diagups = [(j + 1, i - k) for k in range(1, g + 1) if i - k >= 0]
    diagdowns = [(j + 1, i + k) for k in range(1, g + 1) if i + k <= h - 1]
    first_col, last_col = j == 0, j == w - 1
    first_row, last_row = i == 0, i == h - 1

    if not vertical:
        if last_row:
            return [] if last_col else [right] + diagups
        if first_row:
            if last_col:
                return [down]
            if first_col:
                return [right, down] + diagdowns
            return [right] + diagdowns
        if last_col:
            return [down]
        if first_col:
            return [right, down] + diagups + diagdowns
        return [right] + diagups + diagdowns

    if last_row:
        return [] if last_col else [right, up] + diagups
    if first_row:
        if last_col:
            return [down]
        return [right, down] + diagdowns
    if last_col:
        return [down]
    if first_col:
        return [right, down] + diagups + diagdowns
    return [right, up, down] + diagups + diagdowns


def run_dijkstras(prob_map, start_ind, graph_structure: GraphStructure):
    """Exact host Dijkstra with the original heap's tie-breaking.
    ``prob_map`` is the padded (width+2, height) float map in [0, 1];
    returns per-vertex ``(distance, predecessor)`` tuples (0 for
    unreachable), indexed by ``col + row * graph_width``."""
    p = np.asarray(prob_map, dtype=np.float64)
    w, h = p.shape
    g = graph_structure.max_grad
    target = w * h - 1
    settled = [None] * (w * h)
    heap = [(0.0, 0, 0, int(start_ind), 0)]
    counter = 1
    while heap:
        dist, _, _, v, prev = heapq.heappop(heap)
        if settled[v] is not None:
            continue
        settled[v] = (dist, prev)
        if v == target:
            break
        j, i = v % w, v // w
        for pos, (j2, i2) in enumerate(
            _neighbours(j, i, w, h, g, graph_structure.vertical)
        ):
            n = j2 + i2 * w
            if settled[n] is not None:
                continue
            edge = 2.0 - (p[j, i] + p[j2, i2])
            pri = 0 if (j2 == j and i2 == i + 1) else pos + 1
            heapq.heappush(heap, (dist + edge, pri, counter, n, v))
            counter += 1
    return [0 if x is None else x for x in settled]


def _backtrack(shortest_paths, w, h):
    coords = []
    node = w * h - 1
    while True:
        j, i = node % w, node // w
        if (j, i) == (0, 0):
            break
        coords.append((j, i))
        node = shortest_paths[node][1]
    return coords


def _exact_u8(prob_map):
    """``(ok, u8)``: ok when the [0, 1] float map is exactly a uint8/255
    quantization, the grid on which the integer DP is bit-exact."""
    q = np.clip(np.rint(prob_map * 255.0), 0, 255)
    return np.array_equal(q / 255.0, prob_map), q.astype(np.uint8)


def _delineate_u8(maps_u8, max_grad, device):
    """The integer DP (exact ties) on uint8 maps ``(..., W, H)``."""
    maps = torch.from_numpy(np.ascontiguousarray(maps_u8)).to(device)
    return minpath_ops.delineate(maps, max_grad=max_grad).cpu().numpy()


def delineate_boundary(prob_map, graph_structure: GraphStructure, device=None):
    """One row per column of a (W, H) probability map in [0, 1]: the
    integer DP for standard graphs on the uint8/255 grid, the float64
    host Dijkstra otherwise and for vertical graphs. A column the path
    visits twice keeps its last row; :func:`delineate_boundary_vertical`
    averages instead."""
    device = resolve_device(device)
    prob_map = np.asarray(prob_map, dtype=np.float64)
    if not graph_structure.vertical:
        ok, maps_u8 = _exact_u8(prob_map)
        if ok:
            return _delineate_u8(maps_u8, graph_structure.max_grad, device).astype(
                np.float64
            )
    padded = append_firstlast_cols(prob_map)
    paths = run_dijkstras(padded, 0, graph_structure)
    w, h = padded.shape
    delin = np.zeros(w - 2)
    for j, i in _backtrack(paths, w, h):
        if j not in (0, w - 1):
            delin[j - 1] = i  # last write wins
    return delin


def delineate_boundary_vertical(prob_map, graph_structure: GraphStructure):
    """Host Dijkstra on the vertical graph; the rows of a column visited
    several times are averaged."""
    prob_map = np.asarray(prob_map, dtype=np.float64)
    gs = GraphStructure(graph_structure.shape, graph_structure.max_grad, True)
    padded = append_firstlast_cols(prob_map)
    paths = run_dijkstras(padded, 0, gs)
    w, h = padded.shape
    delin = np.zeros(w - 2)
    counts = np.zeros(w - 2)
    for j, i in _backtrack(paths, w, h):
        if j not in (0, w - 1):
            delin[j - 1] += i
            counts[j - 1] += 1
    return delin / np.maximum(counts, 1)


def calc_errors(prediction, truth):
    """prediction - truth, NaN where the truth is NaN or <= 0."""
    prediction = np.asarray(prediction, dtype=np.float64)
    truth = np.asarray(truth, dtype=np.float64)
    invalid = np.isnan(truth) | (truth <= 0)
    return np.where(invalid, np.nan, prediction - truth)


def segment_maps(
    prob_maps,
    truths,
    graph_structure: GraphStructure,
    float_map_backend: str = "device",
    device=None,
):
    """Delineate a stack of maps and compute per-column errors.

    Args:
      prob_maps: ``(num_maps, W, H)`` maps on the 0..255 scale, uint8 or
        float.
      truths: ``(num_maps, W)`` true rows or None.
      float_map_backend: the route of float maps that are not on the
        uint8/255 grid (uint8 maps and integer-valued float maps always
        take the bit-exact integer DP). ``"device"``: the float column DP
        (cost-optimal, "fast" ties). ``"host"``: the per-map host
        Dijkstra, with the original heap's exact float64 tie order and
        about 1000 times slower.
      device: where the DP runs (None means CUDA).

    Returns ``(predictions uint16, errors float64, prob_maps / 255)``.
    """
    if float_map_backend not in ("device", "host"):
        raise ValueError(
            f"unknown float_map_backend: {float_map_backend!r} "
            "(expected 'device' or 'host')"
        )
    device = resolve_device(device)
    prob_maps = np.asarray(prob_maps)
    num_maps, width = prob_maps.shape[0], prob_maps.shape[1]
    max_grad = graph_structure.max_grad

    def host_dijkstra():
        return np.stack(
            [
                delineate_boundary(prob_maps[m] / 255.0, graph_structure, device)
                for m in range(num_maps)
            ]
        ).astype(np.uint16)

    if graph_structure.vertical:
        log.info(
            "segment_maps: vertical graph structure — per-map host "
            "Dijkstra (no device route exists for cyclic graphs)"
        )
        predictions = host_dijkstra()
    elif prob_maps.dtype == np.uint8:
        predictions = _delineate_u8(prob_maps, max_grad, device).astype(np.uint16)
    else:
        ok, maps_u8 = _exact_u8(prob_maps / 255.0)
        if ok:
            predictions = _delineate_u8(maps_u8, max_grad, device).astype(np.uint16)
        elif float_map_backend == "host":
            log.info(
                "segment_maps: non-quantized float maps (dtype=%s) with "
                "float_map_backend='host' — per-map host Dijkstra "
                "(exact heap tie order, ~1000x the device DP)",
                prob_maps.dtype,
            )
            predictions = host_dijkstra()
        else:
            log.info(
                "segment_maps: non-quantized float maps (dtype=%s) take the "
                "device float DP — cost-optimal 'fast' tie semantics; "
                "float_map_backend='host' gives the exact heap tie order",
                prob_maps.dtype,
            )
            # float32, as the JAX package computes it by default.
            maps = torch.from_numpy((prob_maps / 255.0).astype(np.float32)).to(device)
            predictions = (
                minpath_ops.delineate_float(maps, max_grad=max_grad)
                .cpu()
                .numpy()
                .astype(np.uint16)
            )

    errors = np.zeros((num_maps, width), dtype=np.float64)
    if truths is not None:
        for m in range(num_maps):
            errors[m] = calc_errors(predictions[m], truths[m])

    return predictions, errors, prob_maps / 255


def calculate_overall_errors(errors):
    """[mean_abs, mean, sd_abs, sd] per boundary, NaN-aware."""
    errors = np.asarray(errors, dtype=np.float64)
    abs_errors = np.abs(errors)
    return [
        np.nanmean(abs_errors, axis=1),
        np.nanmean(errors, axis=1),
        np.nanstd(abs_errors, axis=1),
        np.nanstd(errors, axis=1),
    ]
