"""Tests of the port that need an NVIDIA GPU: they skip elsewhere.

They import neither JAX nor ``tests/conftest.py``'s setup, so on a
machine with a card and no JAX they run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from oct_image_segmentation_models_torch.ops.minpath import delineate_reference
from oct_image_segmentation_models_torch.ops.minpath_cuda import delineate_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _maps(rng, n, w, h):
    sparse = (rng.random((n, w, h)) < 0.2).astype(np.uint8) * 255
    ridge = np.zeros((n, w, h), np.uint8)
    rows = np.clip(h // 2 + np.cumsum(rng.integers(-2, 3, (n, w)), 1), 0, h - 1)
    ridge[np.arange(n)[:, None], np.arange(w)[None, :], rows] = 255
    ridge |= np.roll(ridge, 1, axis=2)
    return np.concatenate([sparse, ridge, rng.integers(0, 256, (n, w, h), np.uint8)])


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
@pytest.mark.parametrize("n,w,h,g", [(3, 40, 11, 1), (2, 64, 96, 2), (1, 128, 600, 1)])
def test_kernel_matches_reference(cuda, n, w, h, g, tie_parity):
    maps = torch.from_numpy(_maps(np.random.default_rng(h), n, w, h)).to(cuda)
    before = delineate_cuda.launches
    got = delineate_cuda(maps, max_grad=g, tie_parity=tie_parity)
    torch.cuda.synchronize()
    assert delineate_cuda.launches == before + 1
    want = delineate_reference(maps, max_grad=g, tie_parity=tie_parity)
    assert torch.equal(got, want)


def test_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="H <= 1024"):
        delineate_cuda(torch.zeros((1, 4, 1025), dtype=torch.uint8, device=cuda))
    with pytest.raises(TypeError, match="uint8"):
        delineate_cuda(torch.zeros((1, 4, 8), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        delineate_cuda(torch.zeros((1, 8, 4), dtype=torch.uint8, device=cuda).mT)
