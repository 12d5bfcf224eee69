"""Plain boundary maps and min-path rows, the served path's tail.

A frozen copy of the semantics the served rows are held to, so that a
later change to the program cannot move them:

- :func:`boundary_maps_from_labels`: boundary ``i`` of ``(B, H, W)``
  labels is the first row of class ``i + 1``: ``2 * np.gradient`` of the
  class mask along the rows, the positive part thinned to one row, times
  255 with NumPy's uint8 wrap (the first boundary takes the background's
  mask with a negated gradient, ``bg_ilm``).
- :func:`delineate_fast`: the reference graph search (a Dijkstra over the
  transposed ``(W, H)`` map between two virtual all-ones columns, edge
  weight ``510 - m_u - m_v``) as a column dynamic program with
  ``|r_{j+1} - r_j| <= max_grad``, ties among cost-optimal paths broken by
  the packed ancestor chains of the "fast" tie mode.
"""

from __future__ import annotations

import torch

_BIG = 2**30


def boundary_maps_from_labels(labels: torch.Tensor, num_classes: int, bg_ilm: bool = True,
                              bg_csi: bool = False) -> torch.Tensor:
    """``(B, H, W)`` integer labels -> ``(B, C-1, H, W)`` uint8 maps."""
    lab = labels.to(torch.int32)

    def vgrad2(oh):
        interior = oh[..., 2:, :] - oh[..., :-2, :]
        first = 2 * (oh[..., 1:2, :] - oh[..., 0:1, :])
        last = 2 * (oh[..., -1:, :] - oh[..., -2:-1, :])
        return torch.cat([first, interior, last], dim=-2)

    maps = []
    for i in range(1, num_classes):
        bg = (i == 1 and bg_ilm) or (i == num_classes - 1 and bg_csi)
        g2 = -vgrad2((lab == i - 1).to(torch.int32)) if bg else vgrad2((lab == i).to(torch.int32))
        r = torch.clamp(g2, min=0)
        v = torch.clamp(r - torch.roll(r, -1, dims=-2), min=0)
        maps.append((v * 255).to(torch.uint8))
    return torch.stack(maps, dim=1)


def _offsets(g: int) -> list:
    """Candidate predecessors in tie-break order: same row, +1..+g, -1..-g."""
    return [0] + list(range(1, g + 1)) + [-k for k in range(1, g + 1)]


def _shift_up(x, k):
    return torch.cat([x[..., k:], x.new_full(x.shape[:-1] + (k,), _BIG)], dim=-1)


def _shift_down(x, k):
    return torch.cat([x.new_full(x.shape[:-1] + (k,), _BIG), x[..., :-k]], dim=-1)


def delineate_fast(maps_u8: torch.Tensor, max_grad: int = 1) -> torch.Tensor:
    """``(N, W, H)`` uint8 maps (column, row) -> ``(N, W)`` int32 rows."""
    pb = (3 + 2 * max_grad).bit_length()
    if 2 * (9 + pb) > 31:
        raise ValueError(f"max_grad={max_grad} is too large")
    n, w, h = maps_u8.shape
    dev = maps_u8.device
    m = maps_u8.to(torch.int32)
    g = max_grad
    offsets = _offsets(g)
    offsets_t = torch.tensor(offsets, dtype=torch.int32, device=dev)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    zero = i32(0)
    rows_b = torch.arange(h, dtype=torch.int32, device=dev).expand(n, h)
    d = 255 - m[:, 0, :]
    pri_prev = torch.ones_like(d)
    lb = 9 + pb
    lmask = (1 << lb) - 1
    p1m, p2m = i32(((1 << pb) - 1) << lb), i32((1 << pb) - 1)
    rb = max(9, (h - 1).bit_length())
    rmask = (1 << rb) - 1
    vlvl = i32((510 << pb) | 1)
    c1 = ((((255 + m[:, 0, :]) << pb) | 1) << lb) | torch.where(rows_b >= 1, vlvl, zero)
    c2 = (torch.where(rows_b >= 2, vlvl, zero) << lb) | torch.where(rows_b >= 3, vlvl, zero)
    rw = (rows_b << rb) | torch.clamp(rows_b - 1, min=0)

    rows_1h = torch.arange(h, dtype=torch.int32, device=dev)[None, :]
    pris = [torch.full((1, h), 1 + k, dtype=torch.int32, device=dev) for k in range(g + 1)]
    pris += [1 + torch.clamp(rows_1h - k, max=g) + k for k in range(1, g + 1)]
    n_cand = len(offsets)
    pri_b = torch.stack(pris, dim=0).expand(n_cand, n, h)
    cand_rows_b = torch.stack([(rows_1h + o).expand(1, h) for o in offsets], dim=0).expand(n_cand, n, h)

    def shifts(x):
        out = [x] + [_shift_up(x, k) for k in range(1, g + 1)] + [_shift_down(x, k) for k in range(1, g + 1)]
        return torch.stack(out, dim=0)

    def refine(valid, key):
        masked = torch.where(valid, key, _BIG)
        return valid & (masked == masked.min(dim=0, keepdim=True).values)

    def gather0(x, idx):
        return torch.gather(x, 0, idx[None]).squeeze(0)

    def wfield(c, shift):
        return ((c >> shift) & 511) == 510

    def mask(cond, bits):
        return torch.where(cond, bits, zero)

    m_prev = m[:, 0, :]
    choices = []
    for j in range(1, w):
        m_cur = m[:, j, :]
        stacked = shifts(d - m_prev)
        best = stacked.min(dim=0).values
        tied = stacked == best[None]
        d_new = best + 510 - m_cur
        sh_d, sh_pp, sh_m = shifts(d), shifts(pri_prev), shifts(m_prev)
        sh_c1, sh_c2, sh_rw = shifts(c1), shifts(c2), shifts(rw)

        # Zero-weight edges (both ends 255) race the predecessor's settle
        # against the strict pop.
        zero_edge = (sh_m == 255) & (m_cur == 255)[None]
        strict = tied & ~zero_edge
        pri_strict = torch.where(strict, pri_b, _BIG)
        best_strict_pri = pri_strict.min(dim=0).values
        s_choice = torch.argmin(torch.where(pri_strict == best_strict_pri[None], sh_c1, _BIG), dim=0)
        s_pack = ((gather0(sh_m, s_choice) + m_cur) << pb) | (gather0(sh_pp, s_choice) + 1)
        s_gc1 = gather0(sh_c1, s_choice)
        s_c1 = ((s_pack << lb) | (s_gc1 >> lb))[None]
        s_c2 = (((s_gc1 & lmask) << lb) | (gather0(sh_c2, s_choice) >> lb))[None]
        s_rw = gather0(sh_rw, s_choice)[None]
        supp1 = wfield(sh_c1, pb) | wfield(s_c1, pb)
        supp2 = wfield(sh_c2, lb + pb) | wfield(s_c2, lb + pb)
        supp3 = wfield(sh_c2, pb) | wfield(s_c2, pb)
        u_c1 = sh_c1 & ~mask(supp1, p1m) & ~mask(supp2, p2m)
        sv_c1 = s_c1.expand_as(sh_c1) & ~mask(supp1, p1m) & ~mask(supp2, p2m)
        u_c2 = sh_c2 & ~mask(supp3, p1m) & ~p2m
        sv_c2 = s_c2.expand_as(sh_c2) & ~mask(supp3, p1m) & ~p2m
        m1 = (sh_rw >> rb) == (s_rw >> rb)
        m2 = (sh_rw & rmask) == (s_rw & rmask)
        u_c1 = u_c1 & ~mask(m1, p1m) & ~mask(m2, p2m)
        sv_c1 = sv_c1 | mask(m1, p1m) | mask(m2, p2m)
        pu, ps = sh_pp, best_strict_pri[None]
        zero_valid = tied & zero_edge & (
            (pu < ps) | ((pu == ps) & ((u_c1 < sv_c1) | ((u_c1 == sv_c1) & (u_c2 <= sv_c2))))
        )
        valid = strict | zero_valid
        valid = torch.where(valid.any(dim=0, keepdim=True), valid, tied)

        best_pri = torch.where(valid, pri_b, _BIG).min(dim=0).values
        valid = refine(valid, pri_b)
        for key in (sh_d, sh_pp, sh_c1, sh_c2, cand_rows_b):
            valid = refine(valid, key)
        choice = torch.argmax(valid.to(torch.uint8), dim=0)

        c_pack = ((gather0(sh_m, choice) + m_cur) << pb) | (gather0(sh_pp, choice) + 1)
        c_gc1 = gather0(sh_c1, choice)
        pred_row = gather0(cand_rows_b, choice)
        d, m_prev, pri_prev = d_new, m_cur, best_pri
        c1 = (c_pack << lb) | (c_gc1 >> lb)
        c2 = ((c_gc1 & lmask) << lb) | (gather0(sh_c2, choice) >> lb)
        rw = (pred_row << rb) | (gather0(sh_rw, choice) >> rb)
        choices.append(choice.to(torch.uint8))

    # Exit into the virtual column: minimal exit distance, then the keys.
    exit_dist = d + 255 - m_prev
    tied_e = exit_dist == exit_dist.min(dim=-1, keepdim=True).values
    for key in (d, pri_prev, c1, c2):
        masked = torch.where(tied_e, key, _BIG)
        tied_e = tied_e & (masked == masked.min(dim=-1, keepdim=True).values)
    r = torch.argmax(tied_e.to(torch.uint8), dim=-1).to(torch.int32)
    idx = torch.arange(n, device=dev)
    rows = [r]
    for col in reversed(choices):
        r = r + offsets_t[col[idx, r.long()].long()]
        rows.append(r)
    rows.reverse()
    return torch.stack(rows, dim=1)


def rows_from_labels(labels: torch.Tensor, num_classes: int, max_grad: int = 1) -> torch.Tensor:
    """``(B, H, W)`` labels -> ``(B, C-1, W)`` int32 fast-tie rows."""
    maps = boundary_maps_from_labels(labels, num_classes)
    b, m, h, w = maps.shape
    return delineate_fast(maps.transpose(-1, -2).reshape(b * m, w, h).contiguous(), max_grad).reshape(b, m, w)
