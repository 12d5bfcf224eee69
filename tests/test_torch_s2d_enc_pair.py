"""The port's fused s2d encoder pair (``ops/s2d_enc_pair.py``) against the
JAX ``ops/s2d_pallas.py``, whose Pallas kernel runs in interpret mode here.

Both sides are float32 sums of depth up to 4 * 4C in another order, so
outputs are held within atol 1e-4 (the JAX test's figure for its kernel
against the unfused ops); the whole forward with fused pairs within
atol 1e-5 (the figure of the JAX test of build_s2d_apply with fused pairs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops import s2d_pallas as jp
from oct_image_segmentation_models_tpu.ops import s2d_unet as js
from oct_image_segmentation_models_torch.common.model_io import state_dict_from_flax
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.ops import s2d_enc_pair as tp
from oct_image_segmentation_models_torch.ops import s2d_unet as ts
from oct_image_segmentation_models_torch.ops.s2d_enc_pair_cuda import fused_enc_pair_cuda

PAIR_ATOL = 1e-4
FORWARD_ATOL = 1e-5


def _pair_inputs(nh, nw, cgroups, cin=2, B=2, seed=0):
    """Inputs of tests/test_s2d_pallas.py: transformed random 3x3 kernels."""
    rng = np.random.default_rng(seed)
    c = cgroups
    w0 = rng.normal(size=(3, 3, cin, c)).astype(np.float32)
    b0 = rng.normal(size=(c,)).astype(np.float32)
    wb = rng.normal(size=(3, 3, c, c)).astype(np.float32)
    bb = rng.normal(size=(c,)).astype(np.float32)
    x = rng.normal(size=(B, nh, nw, 4 * cin)).astype(np.float32)
    W1, _, _ = js.transform_kernel(w0, 0, 1)
    W2, _, _ = js.transform_kernel(wb, 1, 0)
    return x, W1, np.tile(b0, 4), W2, np.tile(bb, 4)


@pytest.mark.parametrize("nh,nw,cgroups", [(8, 16, 8), (4, 8, 16), (6, 5, 4)])
def test_reference_matches_pallas_interpret(nh, nw, cgroups):
    args = _pair_inputs(nh, nw, cgroups)
    want_y2, want_pool = jp.fused_enc_pair(*map(jnp.asarray, args), interpret=True)
    got_y2, got_pool = tp.fused_enc_pair(*map(torch.from_numpy, args))  # CPU: plain
    assert got_y2.shape == (2, nh, nw, 4 * cgroups)
    assert got_pool.shape == (2, nh, nw, cgroups)
    np.testing.assert_allclose(got_y2.numpy(), np.asarray(want_y2), rtol=0, atol=PAIR_ATOL)
    np.testing.assert_allclose(
        got_pool.numpy(), np.asarray(want_pool), rtol=0, atol=PAIR_ATOL
    )
    # pooled is exactly the phase max of the same y2.
    assert torch.equal(got_pool, ts.phase_max_pool(got_y2))


_TF32_DROP = (1 << 13) - 1  # float32 mantissa bits below TF32's 10


def tf32_split(v: torch.Tensor):
    """The CUDA kernel's 3xTF32 split of a float32 tensor, as the tensor
    cores see it: ``hi`` is ``v`` rounded to TF32, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``), and ``lo`` is ``v - hi`` (exact in
    float32) with its low 13 mantissa bits dropped (an MMA reads the top 19
    bits of a TF32 operand)."""
    bits = v.contiguous().view(torch.int32)
    hi = ((bits + (1 << 12)) & ~_TF32_DROP).view(torch.float32)
    lo = ((v - hi).contiguous().view(torch.int32) & ~_TF32_DROP).view(torch.float32)
    return hi, lo


def test_tf32_split_gives_back_the_operand():
    rng = np.random.default_rng(3)
    v = rng.standard_normal(100_000) * np.exp(4 * rng.standard_normal(100_000))
    v = torch.from_numpy(v.astype(np.float32))
    hi, lo = tf32_split(v)
    for part in (hi, lo):  # TF32 values: the low 13 mantissa bits are 0
        assert not (part.view(torch.int32) & 0x1FFF).any()
    v64 = v.double()
    assert float(((hi.double() - v64).abs() / v64.abs()).max()) <= 2**-11
    assert float(((hi.double() + lo.double() - v64).abs() / v64.abs()).max()) <= 2**-21


def _tf32_pair(x, w1, b1, w2, b2, terms):
    """The encoder pair with each conv's products taken from TF32 operands
    as the kernel's tensor cores take them: ``hi * hi`` alone (1xTF32) or
    ``hi * hi + hi * lo + lo * hi`` (3xTF32), summed in float64."""

    def conv(a, w_hwio, b, pads):
        (ah, al), (wh, wl) = tf32_split(a), tf32_split(w_hwio)
        pairs = [(ah, wh), (ah, wl), (al, wh)][:terms]
        out = sum(
            ts._conv_nchw(u.double(), v.permute(3, 2, 0, 1).double(), None, pads)
            for u, v in pairs
        )
        return (out + b.double()[None, :, None, None]).float()

    x = x.permute(0, 3, 1, 2).contiguous()
    _, _, nh, nw = x.shape
    pads1 = ts._conv_pads(nh, nw, (-1, 0), (-1, 0), nh + 1, nw + 1)
    y1 = ts._mask_shifted_nchw(F.relu(conv(x, w1, b1, pads1)))
    pads2 = ts._conv_pads(nh + 1, nw + 1, (0, 1), (0, 1), nh, nw)
    y2 = F.relu(conv(y1, w2, b2, pads2))
    return y2.permute(0, 2, 3, 1), ts._phase_max_pool_nchw(y2).permute(0, 2, 3, 1)


@pytest.mark.parametrize("terms,within", [(3, True), (1, False)])
def test_tf32_emulation_at_level1_depth(terms, within):
    """3xTF32 (the kernel's scheme) stays within the pair's 1e-4 of the
    Pallas kernel at level-1 depth (4Cin 128, 4C 256); 1xTF32 does not."""
    rng = np.random.default_rng(11)
    B, nh, nw, cin4, c4 = 2, 4, 6, 128, 256

    def t(*shape, fan_in=1):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    args = (
        t(B, nh, nw, cin4),
        t(2, 2, cin4, c4, fan_in=4 * cin4),
        t(c4),
        t(2, 2, c4, c4, fan_in=4 * c4),
        t(c4),
    )
    want_y2, want_pool = jp.fused_enc_pair(*map(jnp.asarray, args), interpret=True)
    y2, pooled = _tf32_pair(*map(torch.from_numpy, args), terms)
    err = max(
        float(np.abs(y2.numpy() - np.asarray(want_y2)).max()),
        float(np.abs(pooled.numpy() - np.asarray(want_pool)).max()),
    )
    assert (err <= PAIR_ATOL) == within, err


def test_enc_pair_supported_matches_jax():
    for nh in (1, 2, 3, 4, 6, 7, 8, 12, 128):
        for cin4 in (4, 8, 64, 128, 256, 384):
            for c4 in (64, 128, 256, 512):
                assert tp.enc_pair_supported(nh, 16, cin4, c4) == jp.enc_pair_supported(
                    nh, 16, cin4, c4
                ), (nh, cin4, c4)
                assert tp._pick_tr(nh) == jp._pick_tr(nh)


def test_forward_with_fused_pairs_matches_jax(monkeypatch):
    container = jax_model_class("unet")(
        input_channels=1, num_classes=3, image_height=32, image_width=32,
        start_neurons=32, pool_layers=2,
    )
    module = container.build_model()
    variables = jax.jit(
        lambda k: module.init(k, np.zeros((1, 32, 32, 1), np.float32), training=False)
    )(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 1)).astype(np.float32)
    want = np.asarray(
        js.build_s2d_apply(
            dict(variables), container.get_config(), fuse_enc_pairs=True,
            _fused_interpret=True,
        )(x)
    )
    port = get_model_class("unet")(**container.get_config()).build_model(device="cpu")
    port.load_state_dict(
        state_dict_from_flax(jax.tree_util.tree_map(np.asarray, dict(variables)))
    )
    fused = ts.build_s2d_apply(port, fuse_enc_pairs=True)
    # Level 1 (4Cin = 128, 4C = 256, 8 block rows) takes the fused pair;
    # level 0 (4Cin = 4) does not.
    assert sorted(fused._fused_levels) == [0, 1]
    calls = []
    real = tp.fused_enc_pair_reference

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(tp, "fused_enc_pair_reference", spy)
    with torch.no_grad():
        got = fused(torch.from_numpy(x)).numpy()
    assert calls == [(2, 8, 8, 128)]
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)
    with torch.no_grad():
        unfused = ts.build_s2d_apply(port)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, unfused, rtol=0, atol=FORWARD_ATOL)


def test_wrappers_reject_what_they_do_not_take():
    x, w1, b1, w2, b2 = map(torch.from_numpy, _pair_inputs(4, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_enc_pair_cuda(x, w1, b1, w2, b2)
    with pytest.raises(TypeError, match="float32"):
        tp.fused_enc_pair(x.double(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w2 must be"):
        tp.fused_enc_pair(x, w1, b1, w2[:, :, :8], b2)
    with pytest.raises(ValueError, match="w1 must be"):
        tp.fused_enc_pair(x, w1[:, :, :4], b1, w2, b2)
    with pytest.raises(ValueError, match="biases"):
        tp.fused_enc_pair(x, w1, b1[:4], w2, b2)
