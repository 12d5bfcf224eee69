"""Tests of the port that need an NVIDIA GPU: they skip elsewhere.

They import neither JAX nor ``tests/conftest.py``'s setup, so on a
machine with a card and no JAX they run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from oct_image_segmentation_models_torch.ops.boundary import image_maps_to_s2d
from oct_image_segmentation_models_torch.ops.minpath import (
    delineate_reference,
    delineate_s2d_reference,
)
from oct_image_segmentation_models_torch.ops.minpath_cuda import (
    delineate_cuda,
    delineate_cuda_s2d,
)
from oct_image_segmentation_models_torch.ops.s2d_enc_pair import (
    fused_enc_pair,
    fused_enc_pair_reference,
)
from oct_image_segmentation_models_torch.ops.s2d_enc_pair_cuda import (
    fused_enc_pair_cuda,
)
from oct_image_segmentation_models_torch.ops.s2d_unet import phase_max_pool

# The encoder-pair kernel sums in another order than cuDNN: float32 sums of
# depth up to 4 * 4C = 1024 at O(1) activations (the JAX kernel test's 1e-4).
PAIR_ATOL = 1e-4


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


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
@pytest.mark.parametrize("b,m,h,w,g", [(1, 3, 12, 40, 1), (2, 1, 96, 64, 2), (1, 1, 600, 128, 1)])
def test_s2d_kernel_matches_reference(cuda, b, m, h, w, g, tie_parity):
    rng = np.random.default_rng(h + w)
    b *= 3  # the sparse, ridge and random families of _maps
    maps_t = torch.from_numpy(_maps(rng, b * m // 3, w, h)).to(cuda)  # (N, W, H)
    s2d = image_maps_to_s2d(maps_t.transpose(-1, -2).reshape(b, m, h, w))
    before = delineate_cuda_s2d.launches, delineate_cuda.launches
    got = delineate_cuda_s2d(s2d, max_grad=g, tie_parity=tie_parity)
    torch.cuda.synchronize()
    assert (delineate_cuda_s2d.launches, delineate_cuda.launches) == (
        before[0] + 1,
        before[1],
    )
    assert got.shape == (b, m, w)
    assert torch.equal(got, delineate_s2d_reference(s2d, max_grad=g, tie_parity=tie_parity))
    b1 = delineate_cuda(maps_t.reshape(b, m, w, h).contiguous(), max_grad=g, tie_parity=tie_parity)
    assert torch.equal(got, b1)


@pytest.mark.parametrize(
    "b,nh,nw,cin4,c4", [(2, 6, 10, 8, 64), (1, 9, 17, 12, 40), (2, 16, 24, 128, 256)]
)
def test_enc_pair_kernel_matches_reference(cuda, b, nh, nw, cin4, c4):
    rng = np.random.default_rng(nh * nw)

    def t(*shape, fan_in):
        a = (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
        return torch.from_numpy(a).to(cuda)

    x = t(b, nh, nw, cin4, fan_in=1)
    w1, b1 = t(2, 2, cin4, c4, fan_in=4 * cin4), t(c4, fan_in=1)
    w2, b2 = t(2, 2, c4, c4, fan_in=4 * c4), t(c4, fan_in=1)
    before = fused_enc_pair_cuda.launches
    y2, pooled = fused_enc_pair(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_enc_pair_cuda.launches == before + 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want_y2, _ = fused_enc_pair_reference(x, w1, b1, w2, b2)
    assert y2.shape == (b, nh, nw, c4) and pooled.shape == (b, nh, nw, c4 // 4)
    assert float((y2 - want_y2).abs().max()) <= PAIR_ATOL
    assert torch.equal(pooled, phase_max_pool(y2))


def test_enc_pair_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((1, 4, 4, 8), device=cuda)
    w1, w2 = torch.zeros((2, 2, 8, 12), device=cuda), torch.zeros((2, 2, 12, 12), device=cuda)
    b = torch.zeros(12, device=cuda)
    with pytest.raises(ValueError, match="4C % 8"):
        fused_enc_pair_cuda(x, w1, b, w2, b)
    w1, w2, b = w1[..., :8].contiguous(), w2[:, :, :8, :8].contiguous(), b[:8]
    with pytest.raises(ValueError, match="contiguous"):
        fused_enc_pair_cuda(x.transpose(1, 2), w1, b, w2, b)
    with pytest.raises(ValueError, match="CUDA"):
        fused_enc_pair_cuda(x.cpu(), w1.cpu(), b.cpu(), w2.cpu(), b.cpu())
