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
from test_torch_cuda import FAMILIES, _family_map, _ridge_map, _smooth_rows

# One shape for every family, so JAX compiles once per (max_grad, mode):
# 2 x 3 leading dims (batch x boundary), W = 24 columns, H = 20 rows (not
# a power of two).
LEAD, W, H = (2, 3), 24, 20


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


def _band_maps(seed, n, w, h, max_step=4):
    """255 bands of 1-8 rows wandering across the columns: columns where
    two rows reach the same predecessor at one effective priority, so
    their rank keys tie."""
    rng = np.random.default_rng(seed)
    maps = np.zeros((n, w, h), np.uint8)
    for i in range(n):
        rows = _smooth_rows(rng, w, h - 8, max_step=max_step)
        width = int(rng.integers(1, 9))
        for j, r in enumerate(rows):
            maps[i, j, r : r + width] = 255
    return maps


@pytest.mark.parametrize("seed,max_grad", [(0, 30), (3, 30), (7, 8), (8, 8)])
def test_reference_matches_jax_xla_on_tied_rank_keys(seed, max_grad):
    """Where rank keys tie, the plain version ranks them as the JAX
    bitonic network does (a stable sort gave other rows here)."""
    maps = _band_maps(seed, 3, 48, 40)
    want = np.asarray(jm._delineate_xla(maps, max_grad=max_grad, tie_parity="exact"))
    got = tm.delineate_reference(
        torch.from_numpy(maps), max_grad=max_grad, tie_parity="exact"
    )
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


# Families on which some column holds two rows with equal rank keys.
TIED_KEY_FAMILIES = ("plateau", "sparse")


@pytest.mark.parametrize("max_grad", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_settle_rank_keys_per_column(monkeypatch, family, max_grad):
    """The CUDA kernel ranks each column by a bitonic sort of its packed
    keys (``csrc/minpath.cu``: the 32-bit ``d << FB | pri_eff * P + ctr``
    or the 64-bit ``(d, sub)`` pair, P the kernel's threads). Both widths
    must order the rows as the plain version's ``(d, pri_eff * pad + ctr)``
    pairs, ties included. The keys are unique in every column of the ridge
    families but tie on plateaus, so a rank that counts smaller keys would
    give two rows one rank: the kernel keeps the sorting network. The keys
    are taken from the plain version's own calls of ``_dense_rank``."""
    maps = _family(FAMILIES.index(family) * 10 + max_grad, family)
    calls = []
    dense_rank = tm._dense_rank

    def spy(d_key, sub_key):
        calls.append((d_key.to(torch.int64), sub_key.to(torch.int64)))
        return dense_rank(d_key, sub_key)

    monkeypatch.setattr(tm, "_dense_rank", spy)
    tm.delineate_reference(torch.from_numpy(maps), max_grad=max_grad, tie_parity="exact")
    assert len(calls) == W  # one rank per column
    pad = 1 << (H - 1).bit_length()  # the plain version's power of two
    p = max(32, pad)  # the kernel's threads
    fb = ((2 + 2 * max_grad) * p - 1).bit_length()
    assert (255 + 510 * (W - 1) + 1) << fb <= 0xFFFFFFFF  # 32-bit keys apply
    tied_columns = 0
    for d, sub in calls:
        d, sub = d.reshape(-1, H), sub.reshape(-1, H)
        pair = (d << 32) | sub  # orders as (d, sub)
        sub_kernel = (sub // pad) * p + sub % pad  # pri_eff * P + ctr
        key32 = (d << fb) | sub_kernel
        assert int(key32.max()) < 2**32
        for key in (key32, (d << 32) | sub_kernel):
            for cmp in (torch.lt, torch.eq):
                assert torch.equal(
                    cmp(key[:, :, None], key[:, None, :]),
                    cmp(pair[:, :, None], pair[:, None, :]),
                )
        ordered = pair.sort(dim=-1).values
        tied_columns += int((ordered[:, 1:] == ordered[:, :-1]).any(dim=-1).sum())
    assert (tied_columns > 0) == (family in TIED_KEY_FAMILIES), tied_columns


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
