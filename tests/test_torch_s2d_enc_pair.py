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
