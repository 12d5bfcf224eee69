"""Min-path boundary delineation: one row per column per boundary map.

Counterpart of :mod:`oct_image_segmentation_models_tpu.ops.minpath`. The
reference graph search (a heapq Dijkstra over the transposed ``(W, H)``
map with two virtual all-ones columns) reduces to a column dynamic
program: every path crosses each real column once, so the shortest path
maximises ``sum_j m[j, r_j]`` subject to ``|r_{j+1} - r_j| <= max_grad``.
The DP runs in int32 on the raw uint8 values (edge weight
``510 - m_u - m_v``), an exact rescaling of the reference's float math.

Tie-breaking follows the JAX module op for op: per-column settle ranks
(exact mode), packed ancestor chains ``c1``/``c2`` and predecessor rows
``rw`` for the zero-weight-edge settle races, the exit-row choice and the
backtrack. See the JAX module's docstring for the derivation.

Two implementations share one contract, ``(..., W, H) uint8 ->
(..., W) int32``:

- :func:`delineate_reference`, the plain PyTorch version below. It runs
  on any device and is bit-equal to the JAX ``_delineate_xla``.
- :func:`.minpath_cuda.delineate_cuda`, the hand-written CUDA kernel
  (``csrc/minpath.cu``) that replaces the Pallas TPU kernel.

The s2d maps of the s2d serving path, ``(B, M, Hb, Wb, 4)``, have the
same pair: :func:`delineate_s2d_reference` and
:func:`.minpath_cuda.delineate_cuda_s2d`, which reads the s2d layout in
place. :func:`delineate` and :func:`delineate_s2d` reach both through the
registered operators ``torch.ops.octseg.minpath_delineate[_s2d]``
(:mod:`.minpath_ops`), whose CUDA implementation is the kernel and whose
CPU implementation is the plain version, so that a traced or exported
graph holds one opaque operator.

:func:`delineate_float` is the DP on float maps with "fast" ties, plain
PyTorch on every device as in JAX (an XLA scan there, no Pallas kernel).
"""

from __future__ import annotations

import functools

import torch

_BIG = 2**30

BACKENDS = ("auto", "cuda", "reference")


def validate_max_grad_packing(max_grad: int) -> int:
    """Shared guard of both implementations; returns PB, the bit width of
    the priority field.

    Packed ancestor-chain levels are LB = 9 + PB bits, two per int32;
    beyond 2*LB = 31 the top level reaches the int32 sign bit and signed
    compares would silently mis-order tie races.
    """
    pb = (3 + 2 * max_grad).bit_length()
    if 2 * (9 + pb) > 31:
        raise ValueError(
            f"max_grad={max_grad} exceeds the ancestor-chain packing limit "
            "(priority field needs 2*(9+PB) <= 31 bits, i.e. max_grad <= 30)"
        )
    return pb


def candidate_offsets(max_grad: int) -> list:
    """Row offsets of the candidate predecessors in the reference's
    tie-break order: same row, +1..+g (from below), -1..-g (from above).
    A stored choice is an index into this list."""
    return (
        [0]
        + list(range(1, max_grad + 1))
        + [-k for k in range(1, max_grad + 1)]
    )


def use_operator(maps_u8: torch.Tensor, backend: str) -> bool:
    """True when the registered operator should run: ``"auto"`` takes it
    on every device (its CUDA implementation is the kernel, its CPU
    implementation the plain version); ``"cuda"`` takes it too and raises
    on a CPU tensor; ``"reference"`` calls the plain version directly."""
    if backend == "auto":
        return True
    if backend == "cuda":
        if not maps_u8.is_cuda:
            raise ValueError(
                "backend='cuda' runs the CUDA kernel and needs a CUDA "
                f"tensor, got one on {maps_u8.device}"
            )
        return True
    if backend == "reference":
        return False
    raise ValueError(f"unknown backend: {backend!r} (expected one of {BACKENDS})")


def _check_operator_args(maps_u8: torch.Tensor, max_grad: int, tie_parity: str) -> bool:
    """The plain version's argument checks, made before the operator is
    called, so that both routes raise alike; returns ``exact``."""
    if tie_parity not in ("exact", "fast"):
        raise ValueError(f"unknown tie_parity: {tie_parity}")
    validate_max_grad_packing(max_grad)
    return tie_parity == "exact"


def delineate(
    maps_u8: torch.Tensor,
    max_grad: int = 1,
    tie_parity: str = "exact",
    backend: str = "auto",
) -> torch.Tensor:
    """Delineate ``(..., W, H)`` uint8 maps into ``(..., W)`` int32 rows
    through ``torch.ops.octseg.minpath_delineate`` or the plain version
    (see :func:`use_operator`)."""
    if not use_operator(maps_u8, backend):
        return delineate_reference(maps_u8, max_grad=max_grad, tie_parity=tie_parity)
    exact = _check_operator_args(maps_u8, max_grad, tie_parity)
    return torch.ops.octseg.minpath_delineate(maps_u8, max_grad, exact)


def delineate_s2d(
    maps_s2d_u8: torch.Tensor,
    max_grad: int = 1,
    tie_parity: str = "exact",
    backend: str = "auto",
) -> torch.Tensor:
    """Delineate s2d maps ``(B, M, Hb, Wb, 4)`` uint8 (channels
    ``(q_h, q_w)``) into ``(B, M, 2 Wb)`` int32 rows through
    ``torch.ops.octseg.minpath_delineate_s2d`` or the plain version (see
    :func:`use_operator`)."""
    if not use_operator(maps_s2d_u8, backend):
        return delineate_s2d_reference(
            maps_s2d_u8, max_grad=max_grad, tie_parity=tie_parity
        )
    exact = _check_operator_args(maps_s2d_u8, max_grad, tie_parity)
    return torch.ops.octseg.minpath_delineate_s2d(maps_s2d_u8, max_grad, exact)


def delineate_s2d_reference(
    maps_s2d_u8: torch.Tensor, max_grad: int = 1, tie_parity: str = "exact"
) -> torch.Tensor:
    """Plain version of the s2d min-path: the maps transposed to the
    ``(B, M, W, H)`` orientation, then :func:`delineate_reference`."""
    from .boundary import s2d_maps_to_transposed

    return delineate_reference(
        s2d_maps_to_transposed(maps_s2d_u8).contiguous(),
        max_grad=max_grad,
        tie_parity=tie_parity,
    )


def _shift_up(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[i] = x[i+k] with BIG padding (candidate 'from below')."""
    fill = x.new_full(x.shape[:-1] + (k,), _BIG)
    return torch.cat([x[..., k:], fill], dim=-1)


def _shift_down(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[i] = x[i-k] with BIG padding (candidate 'from above')."""
    fill = x.new_full(x.shape[:-1] + (k,), _BIG)
    return torch.cat([fill, x[..., :-k]], dim=-1)


@functools.lru_cache(maxsize=None)
def _network_stages(pad: int, device: torch.device) -> tuple:
    """The bitonic network's stages over ``pad`` positions: per stage the
    partner of each position t (t ^ j) and whether t keeps the smaller key
    of the pair (the lower of an ascending pair or the upper of a
    descending one)."""
    t = torch.arange(pad, device=device)
    stages = []
    k = 2
    while k <= pad:
        j = k // 2
        while j >= 1:
            stages.append((t ^ j, ((t & j) == 0) == ((t & k) == 0)))
            j //= 2
        k *= 2
    return tuple(stages)


def _bitonic_order(key: torch.Tensor) -> torch.Tensor:
    """Rows of ``key`` (N, H) int64 in the order the JAX reference's
    bitonic network leaves them: keys padded to a power of two with a key
    above every real one, the network's compare-exchange stages with
    strict comparisons, so that equal keys end where that network puts
    them. Returns (N, H) row indices, position t holding the row of rank
    t."""
    n, h = key.shape
    pad = 1 << max(0, (h - 1).bit_length())
    if pad != h:
        key = torch.cat([key, key.new_full((n, pad - h), (_BIG << 32) | _BIG)], dim=-1)
    idx = torch.arange(pad, device=key.device).expand(n, pad)
    for partner, keep_min in _network_stages(pad, key.device):
        # Take the partner's key when it is strictly smaller (keep_min)
        # or strictly larger: equal keys stay where they are.
        other = key[:, partner]
        take = torch.where(keep_min, other < key, other > key)
        key = torch.where(take, other, key)
        idx = torch.where(take, idx[:, partner], idx)
    return idx[:, :h]


def _dense_rank(d_key: torch.Tensor, sub_key: torch.Tensor) -> torch.Tensor:
    """Per-row rank of the lexicographic ``(d_key, sub_key)`` pairs, as
    the JAX reference's bitonic network ranks them.

    The pairs are unique in most columns, and then any sort gives the
    network's ranks. They are not unique in all: on zero-weight plateaus
    two rows can take the same predecessor at the same effective priority
    (``tests/test_torch_minpath.py`` finds such ties on its ``plateau`` and
    ``sparse`` maps), and where the network orders the two otherwise than a
    stable sort would, the delineated rows can differ. So a column batch
    with a tie is ranked by the network itself (:func:`_bitonic_order`).
    Both keys are non-negative int32, so one int64 key orders the pairs.
    """
    key = (d_key.to(torch.int64) << 32) | sub_key.to(torch.int64)
    order = torch.argsort(key, dim=-1, stable=True)
    ordered = torch.gather(key, -1, order)
    if bool((ordered[..., 1:] == ordered[..., :-1]).any()):
        order = _bitonic_order(key)
    ranks = torch.arange(key.shape[-1], dtype=torch.int32, device=key.device)
    rank = torch.empty_like(d_key)
    rank.scatter_(-1, order, ranks.expand_as(order).contiguous())
    return rank


def delineate_reference(
    maps_u8: torch.Tensor, max_grad: int = 1, tie_parity: str = "exact"
) -> torch.Tensor:
    """Plain PyTorch min-path DP, bit-equal to JAX ``_delineate_xla``.

    Args:
      maps_u8: ``(..., W, H)`` uint8 maps in the reference's transposed
        (column, row) orientation, any number of leading dims.
      max_grad: maximum row step per column.
      tie_parity: ``"exact"`` carries per-column settle ranks and
        reproduces the reference heap's tie-breaks; ``"fast"`` refines
        ties over the packed ancestor chains only. Both are cost-optimal.

    Returns:
      int32 rows ``(..., W)`` on the device of ``maps_u8``.
    """
    if tie_parity not in ("exact", "fast"):
        raise ValueError(f"unknown tie_parity: {tie_parity}")
    PB = validate_max_grad_packing(max_grad)
    exact = tie_parity == "exact"
    if maps_u8.ndim < 2:
        raise ValueError("maps must have shape (..., W, H)")
    lead = tuple(maps_u8.shape[:-2])
    w, h = maps_u8.shape[-2], maps_u8.shape[-1]
    dev = maps_u8.device
    m = maps_u8.reshape(-1, w, h).to(torch.int32)
    n = m.shape[0]
    g = max_grad
    offsets = candidate_offsets(g)
    offsets_t = torch.tensor(offsets, dtype=torch.int32, device=dev)

    pad = 1
    while pad < h:
        pad *= 2

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    zero = i32(0)
    rows_b = torch.arange(h, dtype=torch.int32, device=dev).expand(n, h)

    # Column 0: nodes settle in (distance, row) order.
    d0 = 255 - m[:, 0, :]
    rank0 = _dense_rank(d0, rows_b) if exact else torch.zeros_like(d0)
    pri0 = torch.ones_like(d0)

    # Packed ancestor chains: per level (510 - edge weight) in 9 bits and
    # the entry priority + 1 in PB bits, two levels per int32.
    LB = 9 + PB
    LMASK = (1 << LB) - 1
    P1M = i32(((1 << PB) - 1) << LB)
    P2M = i32((1 << PB) - 1)
    RB = max(9, (h - 1).bit_length())
    RMASK = (1 << RB) - 1
    vlvl = i32((510 << PB) | 1)
    c1_0 = ((((255 + m[:, 0, :]) << PB) | 1) << LB) | torch.where(
        rows_b >= 1, vlvl, zero
    )
    c2_0 = (torch.where(rows_b >= 2, vlvl, zero) << LB) | torch.where(
        rows_b >= 3, vlvl, zero
    )
    rw_0 = (rows_b << RB) | torch.clamp(rows_b - 1, min=0)

    # Heap-entry priority per candidate: same row 1, from row+k 1+k,
    # from row-k 1+min(g, row-k)+k.
    rows_1h = torch.arange(h, dtype=torch.int32, device=dev)[None, :]
    pris = [torch.full((1, h), 1, dtype=torch.int32, device=dev)]
    for k in range(1, g + 1):
        pris.append(torch.full((1, h), 1 + k, dtype=torch.int32, device=dev))
    for k in range(1, g + 1):
        pris.append(1 + torch.clamp(rows_1h - k, max=g) + k)
    stacked_pri = torch.stack(pris, dim=0)  # (2g+1, 1, H)
    cand_rows = torch.stack(
        [(rows_1h + off).expand(1, h) for off in offsets], dim=0
    )  # (2g+1, 1, H)
    n_cand = len(offsets)
    stacked_pri_b = stacked_pri.expand(n_cand, n, h)
    cand_rows_b = cand_rows.expand(n_cand, n, h)

    def shifts(x):
        out = [x]
        for k in range(1, g + 1):
            out.append(_shift_up(x, k))
        for k in range(1, g + 1):
            out.append(_shift_down(x, k))
        return torch.stack(out, dim=0)  # (2g+1, N, H)

    def refine(valid, key):
        masked = torch.where(valid, key, _BIG)
        return valid & (masked == masked.min(dim=0, keepdim=True).values)

    def gather0(x, idx):
        return torch.gather(x, 0, idx[None]).squeeze(0)

    def wfield(c, shift):
        return ((c >> shift) & 511) == 510

    def mask(cond, bits):
        return torch.where(cond, bits, zero)

    d, m_prev, pri_prev, rank_prev = d0, m[:, 0, :], pri0, rank0
    c1, c2, rw = c1_0, c2_0, rw_0
    choices = []
    for j in range(1, w):
        m_cur = m[:, j, :]
        stacked = shifts(d - m_prev)
        best = stacked.min(dim=0).values
        tied = stacked == best[None]
        d_new = best + 510 - m_cur

        sh_d = shifts(d)
        sh_pp = shifts(pri_prev)
        sh_m = shifts(m_prev)
        sh_c1 = shifts(c1)
        sh_c2 = shifts(c2)
        sh_rw = shifts(rw)
        stacked_rank = shifts(rank_prev)

        # Heap-entry validity of zero-weight edges (both endpoints 255):
        # race the predecessor's settle against the strict pop.
        zero_edge = (sh_m == 255) & (m_cur == 255)[None]
        strict = tied & ~zero_edge
        pri_strict = torch.where(strict, stacked_pri_b, _BIG)
        best_strict_pri = pri_strict.min(dim=0).values
        strict_rank_m = torch.where(
            pri_strict == best_strict_pri[None],
            stacked_rank if exact else sh_c1,
            _BIG,
        )
        s_choice = torch.argmin(strict_rank_m, dim=0)

        s_pack = ((gather0(sh_m, s_choice) + m_cur) << PB) | (
            gather0(sh_pp, s_choice) + 1
        )
        s_gc1 = gather0(sh_c1, s_choice)
        s_c1 = ((s_pack << LB) | (s_gc1 >> LB))[None]
        s_c2 = (((s_gc1 & LMASK) << LB) | (gather0(sh_c2, s_choice) >> LB))[
            None
        ]
        s_rw = gather0(sh_rw, s_choice)[None]
        # Priority fields compare only where neither side's next chain
        # link is a zero-weight cascade edge (w-field 510).
        supp1 = wfield(sh_c1, PB) | wfield(s_c1, PB)
        supp2 = wfield(sh_c2, LB + PB) | wfield(s_c2, LB + PB)
        supp3 = wfield(sh_c2, PB) | wfield(s_c2, PB)
        u_c1 = sh_c1 & ~mask(supp1, P1M) & ~mask(supp2, P2M)
        sv_c1 = s_c1.expand_as(sh_c1) & ~mask(supp1, P1M) & ~mask(supp2, P2M)
        u_c2 = sh_c2 & ~mask(supp3, P1M) & ~P2M
        sv_c2 = s_c2.expand_as(sh_c2) & ~mask(supp3, P1M) & ~P2M
        # Ancestor merges resolve u-first regardless of priorities.
        m1 = (sh_rw >> RB) == (s_rw >> RB)
        m2 = (sh_rw & RMASK) == (s_rw & RMASK)
        u_c1 = u_c1 & ~mask(m1, P1M) & ~mask(m2, P2M)
        sv_c1 = sv_c1 | mask(m1, P1M) | mask(m2, P2M)
        pu = sh_pp
        ps = best_strict_pri[None]
        zero_valid = (
            tied
            & zero_edge
            & (
                (pu < ps)
                | (
                    (pu == ps)
                    & ((u_c1 < sv_c1) | ((u_c1 == sv_c1) & (u_c2 <= sv_c2)))
                )
            )
        )
        valid = strict | zero_valid
        valid = torch.where(valid.any(dim=0, keepdim=True), valid, tied)

        # Pop entry: lexicographic min over valid entries of (entry
        # priority, insertion counter ~ predecessor settle order).
        best_pri = torch.where(valid, stacked_pri_b, _BIG).min(dim=0).values
        valid = refine(valid, stacked_pri_b)
        if exact:
            rank_m = torch.where(valid, stacked_rank, _BIG)
            entry_ctr = rank_m.min(dim=0).values
            choice = torch.argmin(rank_m, dim=0)
        else:
            for key in (sh_d, sh_pp, sh_c1, sh_c2, cand_rows_b):
                valid = refine(valid, key)
            choice = torch.argmax(valid.to(torch.uint8), dim=0)

        if exact:
            # A zero-edge winner settles no earlier than its predecessor:
            # its rank key takes the larger of the two priority fields.
            zero_chosen = gather0(zero_edge, choice)
            pri_eff = torch.where(
                zero_chosen,
                torch.maximum(best_pri, gather0(sh_pp, choice)),
                best_pri,
            )
            rank_new = _dense_rank(d_new, pri_eff * pad + entry_ctr)
        else:
            rank_new = rank_prev
        c_pack = ((gather0(sh_m, choice) + m_cur) << PB) | (
            gather0(sh_pp, choice) + 1
        )
        c_gc1 = gather0(sh_c1, choice)
        pred_row = gather0(cand_rows_b, choice)
        d, m_prev, pri_prev, rank_prev = d_new, m_cur, best_pri, rank_new
        c1 = (c_pack << LB) | (c_gc1 >> LB)
        c2 = ((c_gc1 & LMASK) << LB) | (gather0(sh_c2, choice) >> LB)
        rw = (pred_row << RB) | (gather0(sh_rw, choice) >> RB)
        choices.append(choice.to(torch.uint8))

    # Exit edge back into the all-ones virtual column: the earliest
    # settled last-column node among those of minimal exit distance.
    exit_dist = d + 255 - m_prev
    tied_e = exit_dist == exit_dist.min(dim=-1, keepdim=True).values
    exit_keys = (rank_prev,) if exact else (d, pri_prev, c1, c2)
    for key in exit_keys:
        masked = torch.where(tied_e, key, _BIG)
        tied_e = tied_e & (masked == masked.min(dim=-1, keepdim=True).values)
    r = torch.argmax(tied_e.to(torch.uint8), dim=-1).to(torch.int32)

    batch_idx = torch.arange(n, device=dev)
    rows = [r]
    for choice_col in reversed(choices):
        c = choice_col[batch_idx, r.long()].long()
        r = r + offsets_t[c]
        rows.append(r)
    rows.reverse()
    return torch.stack(rows, dim=1).reshape(lead + (w,))


def delineate_float(maps: torch.Tensor, max_grad: int = 1) -> torch.Tensor:
    """Cost-optimal ("fast"-tie) column DP for float probability maps,
    counterpart of JAX ``delineate_float`` (an XLA scan there, no Pallas
    kernel).

    Args:
      maps: ``(..., W, H)`` float maps in [0, 1] (the reference's
        ``prob_map / 255`` scale) in the transposed (column, row)
        orientation, any number of leading dims.
      max_grad: maximum row step per column.

    The reference's edge weight ``2 - p_u - p_v`` adds the same 2 to every
    path at a column, so the carried distance is only ``-(sum p)``, which
    keeps float32 rounding at the scale of the path's reward. Candidates
    that tie resolve by the heap's first-order preference (same row, from
    below, from above), the order of the stacked candidates, through the
    first index of ``min``. Subtraction, min and argmin are exact in IEEE
    arithmetic, so every device gives the same rows.

    Returns int32 rows ``(..., W)`` on the device of ``maps``.
    """
    if maps.ndim < 2:
        raise ValueError("maps must have shape (..., W, H)")
    lead = tuple(maps.shape[:-2])
    w, h = maps.shape[-2], maps.shape[-1]
    p = maps.reshape(-1, w, h).to(torch.promote_types(maps.dtype, torch.float32))
    n = p.shape[0]
    offsets_t = torch.tensor(
        candidate_offsets(max_grad), dtype=torch.int32, device=p.device
    )

    def shifts(x):
        out = [x]
        out += [_shift_up(x, k) for k in range(1, max_grad + 1)]
        out += [_shift_down(x, k) for k in range(1, max_grad + 1)]
        return torch.stack(out, dim=0)  # (2g+1, N, H)

    # Entry edge from the all-ones virtual column.
    d, p_prev = -p[:, 0, :], p[:, 0, :]
    choices = []
    for j in range(1, w):
        p_cur = p[:, j, :]
        best, choice = torch.min(shifts(d - p_prev), dim=0)
        choices.append(choice.to(torch.uint8))
        d, p_prev = best - p_cur, p_cur

    # Edge back into the virtual column; the first minimal row wins.
    r = torch.argmin(d - p_prev, dim=-1).to(torch.int32)
    batch_idx = torch.arange(n, device=p.device)
    rows = [r]
    for choice_col in reversed(choices):
        r = r + offsets_t[choice_col[batch_idx, r.long()].long()]
        rows.append(r)
    rows.reverse()
    return torch.stack(rows, dim=1).reshape(lead + (w,))


def delineate_image_maps(
    boundary_maps: torch.Tensor,
    max_grad: int = 1,
    tie_parity: str = "exact",
    backend: str = "auto",
) -> torch.Tensor:
    """Delineate image-orientation maps ``(..., H, W)`` (as produced by
    :func:`.boundary.boundary_prob_maps`) into rows ``(..., W)``."""
    return delineate(
        boundary_maps.transpose(-1, -2).contiguous(),
        max_grad=max_grad,
        tie_parity=tie_parity,
        backend=backend,
    )


def calc_errors(predictions: torch.Tensor, truths: torch.Tensor) -> torch.Tensor:
    """Per-column delineation error ``prediction - truth`` in float32,
    NaN where the truth is NaN or <= 0."""
    predictions = predictions.to(torch.float32)
    truths_f = truths.to(torch.float32)
    invalid = torch.isnan(truths_f) | (truths_f <= 0)
    return torch.where(
        invalid, torch.full_like(predictions, float("nan")), predictions - truths_f
    )


# The operators' CPU implementations are this module's plain versions, so
# they are registered once this module's functions exist.
from . import minpath_ops  # noqa: E402,F401
