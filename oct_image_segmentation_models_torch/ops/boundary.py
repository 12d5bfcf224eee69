"""Boundary-map ops, counterpart of the JAX package's ``ops/boundary.py``.

Bit-equal to the JAX functions (and through them to the reference's
NumPy post-processing):

- :func:`perform_argmax`: argmax class map + class-first categorical;
- :func:`boundary_prob_maps` / :func:`boundary_maps_from_labels`: class
  masks -> per-boundary uint8 ridge maps;
- :func:`boundary_maps_from_s2d_labels`: the same maps computed from
  argmax labels in s2d layout, with :func:`s2d_maps_to_image` and
  :func:`s2d_maps_to_transposed`;
- :func:`repair_segs` / :func:`create_area_mask`: boundary rows -> dense
  region mask, with the NaN/0 repair semantics.

Conventions: label/probability tensors are channels-last ``(B, H, W, C)``;
"categorical" tensors are class-first ``(B, C, H, W)``; boundary ``i`` is
the first row where ``label == i+1``.
"""

from __future__ import annotations

import torch


def to_categorical(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """One-hot encode integer labels (float32), like keras
    ``to_categorical``, dropping a trailing singleton axis first. Labels
    outside ``[0, num_classes)`` encode as all zeros, as in JAX."""
    if labels.ndim > 1 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.to(torch.int64)[..., None] == classes).to(torch.float32)


def perform_argmax(predictions: torch.Tensor, bin: bool = True):
    """``(B, H, W, C)`` probabilities -> ``(argmax (B, H, W) int64,
    categorical (B, C, H, W))``; the categorical is the one-hot of the
    argmax when ``bin``, else the probabilities class-first. Ties take
    the first class."""
    num_classes = predictions.shape[3]
    argmax_pred = torch.argmax(predictions, dim=3)
    if bin:
        categorical = to_categorical(argmax_pred, num_classes).permute(0, 3, 1, 2)
    else:
        categorical = predictions.permute(0, 3, 1, 2)
    return argmax_pred, categorical


def _vertical_gradient(x: torch.Tensor) -> torch.Tensor:
    """``np.gradient(x, axis=-2)``: central differences inside, one-sided
    differences at the first and last row. ``x``: (..., H, W)."""
    interior = (x[..., 2:, :] - x[..., :-2, :]) * 0.5
    first = x[..., 1:2, :] - x[..., 0:1, :]
    last = x[..., -1:, :] - x[..., -2:-1, :]
    return torch.cat([first, interior, last], dim=-2)


def _ridge_from_gradient(grad: torch.Tensor) -> torch.Tensor:
    """Clip negatives, scale x2, subtract the one-row-up roll, clip again."""
    grad = torch.clamp(grad, min=0.0) * 2.0
    rolled = torch.roll(grad, -1, dims=-2)
    return torch.clamp(grad - rolled, min=0.0)


def _to_uint8_wrap(x: torch.Tensor) -> torch.Tensor:
    """``(x * 255).astype(uint8)`` with NumPy's C-cast wraparound: float
    -> int32 -> uint8, so a ridge value of 2.0 wraps to 254. (A direct
    float -> uint8 cast of an out-of-range value is undefined.)"""
    return (x * 255.0).to(torch.int32).to(torch.uint8)


def _use_bg(map_ind: int, num_maps: int, bg_ilm: bool, bg_csi: bool) -> bool:
    return (map_ind == 1 and bg_ilm) or (map_ind == num_maps - 1 and bg_csi)


def boundary_prob_maps(
    categorical_pred: torch.Tensor, bg_ilm: bool = True, bg_csi: bool = False
) -> torch.Tensor:
    """``(B, C, H, W)`` float one-hot (or probabilities) -> ``(B, C-1, H,
    W)`` uint8 boundary maps, 255 on the ridge.

    Map ``i`` is the positive part of the vertical gradient of region
    ``i``'s mask thinned to one row; with ``bg_ilm`` (first boundary) or
    ``bg_csi`` (last boundary) the preceding region's mask is used with a
    negated gradient instead."""
    num_maps = categorical_pred.shape[1]
    maps = []
    for map_ind in range(1, num_maps):
        if _use_bg(map_ind, num_maps, bg_ilm, bg_csi):
            grad = -_vertical_gradient(categorical_pred[:, map_ind - 1])
        else:
            grad = _vertical_gradient(categorical_pred[:, map_ind])
        maps.append(_to_uint8_wrap(_ridge_from_gradient(grad)))
    return torch.stack(maps, dim=1)


def boundary_maps_from_labels(
    labels: torch.Tensor,
    num_classes: int,
    bg_ilm: bool = True,
    bg_csi: bool = False,
) -> torch.Tensor:
    """:func:`boundary_prob_maps` of the one-hot of ``(B, H, W)`` argmax
    labels, in integers: ``2 * np.gradient`` of a binary mask lies in
    {-2..2}, so the conversion is exact and the final ``* 255`` uint8
    cast wraps 510 -> 254 as the float path does."""
    lab = labels.to(torch.int32)

    def vgrad2(oh):
        interior = oh[..., 2:, :] - oh[..., :-2, :]
        first = 2 * (oh[..., 1:2, :] - oh[..., 0:1, :])
        last = 2 * (oh[..., -1:, :] - oh[..., -2:-1, :])
        return torch.cat([first, interior, last], dim=-2)

    maps = []
    for map_ind in range(1, num_classes):
        if _use_bg(map_ind, num_classes, bg_ilm, bg_csi):
            g2 = -vgrad2((lab == map_ind - 1).to(torch.int32))
        else:
            g2 = vgrad2((lab == map_ind).to(torch.int32))
        r = torch.clamp(g2, min=0)
        v = torch.clamp(r - torch.roll(r, -1, dims=-2), min=0)
        maps.append((v * 255).to(torch.uint8))
    return torch.stack(maps, dim=1)


def boundary_maps_from_s2d_labels(
    lab_s2d: torch.Tensor,
    num_classes: int,
    bg_ilm: bool = True,
    bg_csi: bool = False,
    transposed=False,
) -> torch.Tensor:
    """:func:`boundary_maps_from_labels` computed on s2d labels.

    ``lab_s2d``: ``(B, Hb, Wb, 4)`` integer labels, channel layout
    ``(q_h, q_w)``: rows ``2i`` sit in phases ``q_h = 0`` and rows ``2i+1``
    in ``q_h = 1``, so the ``r +- 1`` neighbourhoods of the vertical
    gradient become block shifts along Hb. Output is identical to
    ``boundary_maps_from_labels(d2s(labels), ...)``.

    ``transposed``: False gives image maps ``(B, C-1, H, W)``, True the
    min-path's ``(B, C-1, W, H)``, ``"s2d"`` the s2d-form maps ``(B, C-1,
    Hb, Wb, 4)`` (for :func:`.minpath.delineate_s2d`).
    """
    lab = lab_s2d.to(torch.int32)
    a = lab[..., 0:2]  # rows 2i   (q_h = 0), channels = q_w
    b = lab[..., 2:4]  # rows 2i+1 (q_h = 1)

    def ridge(cls, sign):
        oha = (a == cls).to(torch.int32)
        ohb = (b == cls).to(torch.int32)
        # g2 = sign * 2 * np.gradient(oh, axis=rows), split by row parity:
        #   row 2i   (i>=1): oh[2i+1] - oh[2i-1] = ohb[i] - ohb[i-1]
        #   row 0          : 2*(oh[1] - oh[0])   = 2*(ohb[0] - oha[0])
        #   row 2i+1 (i<nh-1): oh[2i+2] - oh[2i] = oha[i+1] - oha[i]
        #   row H-1        : 2*(oh[H-1] - oh[H-2]) = 2*(ohb[-1] - oha[-1])
        g2_even = torch.cat(
            [2 * (ohb[:, :1] - oha[:, :1]), ohb[:, 1:] - ohb[:, :-1]], dim=1
        )
        g2_odd = torch.cat(
            [oha[:, 1:] - oha[:, :-1], 2 * (ohb[:, -1:] - oha[:, -1:])], dim=1
        )
        rr_even = torch.clamp(sign * g2_even, min=0)
        rr_odd = torch.clamp(sign * g2_odd, min=0)
        # v[r] = max(rr[r] - rr[(r+1) mod H], 0)  (np.roll wraps)
        rr_even_next = torch.cat([rr_even[:, 1:], rr_even[:, :1]], dim=1)
        v_even = torch.clamp(rr_even - rr_odd, min=0)
        v_odd = torch.clamp(rr_odd - rr_even_next, min=0)
        # back to the (q_h, q_w) channel layout; * 255 wraps 510 -> 254
        v = torch.cat([v_even, v_odd], dim=-1) * 255
        return v.to(torch.uint8)

    maps = []
    for map_ind in range(1, num_classes):
        if _use_bg(map_ind, num_classes, bg_ilm, bg_csi):
            maps.append(ridge(map_ind - 1, -1))
        else:
            maps.append(ridge(map_ind, 1))
    m = torch.stack(maps, dim=1)  # (B, M, Hb, Wb, 4)
    if transposed == "s2d":
        return m
    if transposed:
        return s2d_maps_to_transposed(m)
    return s2d_maps_to_image(m)


def s2d_maps_to_image(m: torch.Tensor) -> torch.Tensor:
    """s2d-form maps ``(B, M, Hb, Wb, 4)`` -> image ``(B, M, H, W)``."""
    B, M, Hb, Wb, _ = m.shape
    m = m.reshape(B, M, Hb, Wb, 2, 2)
    # (b, m, i, j, qh, qw) -> (b, m, i, qh, j, qw) = (B, M, H, W)
    return m.permute(0, 1, 2, 4, 3, 5).reshape(B, M, 2 * Hb, 2 * Wb)


def image_maps_to_s2d(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`s2d_maps_to_image`: image maps ``(B, M, H, W)``
    -> contiguous s2d-form maps ``(B, M, H/2, W/2, 4)``, channels
    ``(q_h, q_w)``."""
    B, M, H, W = m.shape
    m = m.reshape(B, M, H // 2, 2, W // 2, 2)
    # (b, m, i, qh, j, qw) -> (b, m, i, j, qh, qw)
    return m.permute(0, 1, 2, 4, 3, 5).reshape(B, M, H // 2, W // 2, 4).contiguous()


def s2d_maps_to_transposed(m: torch.Tensor) -> torch.Tensor:
    """s2d-form maps -> the min-path's ``(B, M, W, H)`` orientation."""
    B, M, Hb, Wb, _ = m.shape
    m = m.reshape(B, M, Hb, Wb, 2, 2)
    # (b, m, i, j, qh, qw) -> (b, m, j, qw, i, qh) = (B, M, W, H)
    return m.permute(0, 1, 3, 5, 2, 4).reshape(B, M, 2 * Wb, 2 * Hb)


def repair_segs(segs: torch.Tensor, image_height: int) -> torch.Tensor:
    """Replace invalid boundary rows (NaN or 0) with the first originally
    valid boundary below, or ``image_height`` if none.

    ``segs``: ``(..., num_boundaries, W)``; returns int32 of that shape."""
    segs_f = segs.to(torch.float32)
    invalid = torch.isnan(segs_f) | (segs_f == 0)
    num_boundaries = segs.shape[-2]
    below = torch.full(
        segs_f.shape[:-2] + segs_f.shape[-1:],
        float(image_height),
        dtype=torch.float32,
        device=segs.device,
    )
    repaired = [None] * num_boundaries
    # Bottom-up: each invalid entry takes the nearest valid original value
    # below it (repairs only ever propagate original values).
    for i in range(num_boundaries - 1, -1, -1):
        repaired[i] = torch.where(invalid[..., i, :], below, segs_f[..., i, :])
        below = repaired[i]
    return torch.stack(repaired, dim=-2).to(torch.int32)


def create_area_mask(segs: torch.Tensor, image_height: int) -> torch.Tensor:
    """Dense uint8 region mask ``(..., H, W)`` from boundary rows
    ``(..., num_boundaries, W)`` (NaN/0 invalid).

    Region ``i`` is written over rows ``[seg_{i-1}, seg_i)`` in boundary
    order (later writes win when repaired boundaries are out of order),
    then rows ``>= seg_{n-1}`` get region ``n``."""
    segs = repair_segs(segs, image_height)
    num_boundaries = segs.shape[-2]
    rows = torch.arange(image_height, dtype=torch.int32, device=segs.device)[:, None]
    mask = torch.zeros(
        segs.shape[:-2] + (image_height, segs.shape[-1]),
        dtype=torch.uint8,
        device=segs.device,
    )
    prev = torch.zeros_like(segs[..., 0, :])
    for i in range(num_boundaries):
        cur = segs[..., i, :]
        write = (rows >= prev[..., None, :]) & (rows < cur[..., None, :])
        mask = torch.where(write, torch.tensor(i, dtype=torch.uint8), mask)
        prev = cur
    return torch.where(
        rows >= prev[..., None, :],
        torch.tensor(num_boundaries, dtype=torch.uint8),
        mask,
    )
