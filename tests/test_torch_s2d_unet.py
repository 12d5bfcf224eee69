"""The port's s2d U-Net forward (``ops/s2d_unet.py``) against the JAX
``ops/s2d_unet.py``.

The weight transform is numpy in both packages and must be bit-equal: the
geometry helpers over a grid of kernels and configs, and the folded,
transformed kernels each forward holds on the goldens' model. The forward
runs float32 convs in another summation order, so probabilities are held
within atol 2e-5 (the JAX test's own tolerance against the parity
module); argmax labels, in image and s2d layout, must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops import s2d_unet as js
from oct_image_segmentation_models_torch.common.model_io import state_dict_from_flax
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.ops import s2d_unet as ts

from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

PROB_ATOL = 2e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@functools.lru_cache(maxsize=None)
def _models(cin, num_classes, h, w, kw_items, seed=0, random_stats=True):
    """A JAX U-Net with (optionally) random BN statistics as in
    tests/test_s2d_unet.py, its variables, its input, and the port module
    holding the same weights."""
    container = jax_model_class("unet")(
        input_channels=cin,
        num_classes=num_classes,
        image_height=h,
        image_width=w,
        **dict(kw_items),
    )
    module = container.build_model()
    key = jax.random.PRNGKey(seed)
    x = jax.random.uniform(key, (2, h, w, cin), jnp.float32)
    variables = jax.jit(lambda k: module.init(k, x, training=False))(key)
    if random_stats:
        bs = jax.tree_util.tree_map(
            lambda a: a + jax.random.uniform(key, a.shape) * 0.1 + 0.05,
            variables["batch_stats"],
        )
        variables = {"params": variables["params"], "batch_stats": bs}
    port = get_model_class("unet")(**container.get_config()).build_model(device="cpu")
    port.load_state_dict(state_dict_from_flax(_np_tree(variables)))
    return container, variables, np.array(x), port


CONFIGS = [
    dict(start_neurons=4, pool_layers=2, conv_layers=2, h=16, w=24),
    dict(start_neurons=8, pool_layers=3, conv_layers=2, h=32, w=32),
    dict(start_neurons=4, pool_layers=2, conv_layers=2, h=16, w=16, cin=3),
]


def _config_models(cfg):
    cfg = dict(cfg)
    cin = cfg.pop("cin", 1)
    h, w = cfg.pop("h"), cfg.pop("w")
    return _models(cin, 3, h, w, tuple(sorted(cfg.items())))


def _run(port_fn, x):
    with torch.no_grad():
        return port_fn(torch.from_numpy(x)).numpy()


# ---------------------------------------------------------------------------
# Geometry and weight transform: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a_in,a_out", [(0, 1), (1, 0), (0, 0), (1, 1)])
@pytest.mark.parametrize("kh,kw", [(1, 1), (2, 2), (3, 3), (2, 3), (3, 1)])
def test_transform_kernel_bit_equal(kh, kw, a_in, a_out):
    rng = np.random.default_rng(kh * 10 + kw + a_in * 100 + a_out * 1000)
    w = rng.normal(size=(kh, kw, 3, 5)).astype(np.float32)
    want = js.transform_kernel(w, a_in, a_out)
    got = ts.transform_kernel(w, a_in, a_out)
    assert got[1:] == want[1:]
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    for k in (kh, kw):
        assert ts._tap_range(k) == js._tap_range(k)
        assert ts._axis_spec(k, a_in, a_out) == js._axis_spec(k, a_in, a_out)
    for part_got, part_want in zip(
        ts._transform_maps(kh, kw, a_in, a_out), js._transform_maps(kh, kw, a_in, a_out)
    ):
        assert np.array_equal(np.asarray(part_got), np.asarray(part_want))


def test_geometry_helpers_match_jax():
    for ca in (1, 4, 8):
        for cb in (1, 3, 8):
            assert np.array_equal(
                ts._split_concat_perm(ca, cb), js._split_concat_perm(ca, cb)
            )
    for n_in, n_out, e in [(8, 9, (-1, 0)), (9, 8, (0, 1)), (8, 8, (0, 1)), (5, 5, (-1, 1))]:
        assert ts._block_pad(n_in, n_out, e) == js._block_pad(n_in, n_out, e)
    for sn in (2, 4, 8, 16, 32, 64, 128):
        for pl in (1, 2, 3, 4):
            for cl in (0, 1, 2, 3, 4):
                for ek, dk in [((3, 3), (2, 2)), ((5, 5), (2, 2)), ((3, 3), (4, 4)), ((1, 3), (2, 2))]:
                    assert ts.s2d_eligible_levels(sn, pl, cl, ek, dk) == (
                        js.s2d_eligible_levels(sn, pl, cl, ek, dk)
                    ), (sn, pl, cl, ek, dk)


def _jax_held_kernels(apply_fn):
    """The folded, transformed (kernel, bias) pairs a JAX ``build_s2d_apply``
    forward holds, in plan order: encoder, bottleneck, decoder, head."""
    cells = dict(
        zip(apply_fn.__code__.co_freevars, (c.cell_contents for c in apply_fn.__closure__))
    )
    out = []
    for level in cells["enc_plan"]:
        out += [(p[1], p[2]) for p in level]
    out += [(p[1], p[2]) for p in cells["bot_plan"]]
    for _, level in cells["dec_plan"]:
        out += [(p[1], p[2]) for p in level]
    out.append(cells["head_s2d"])
    return [(np.asarray(w), np.asarray(b)) for w, b in out]


def test_held_kernels_bit_equal_on_goldens_model():
    container, variables, _, port = _models(
        1, 4, 64, 96, (("pool_layers", 3), ("start_neurons", 4)), seed=1234,
        random_stats=False,
    )
    jfn = js.build_s2d_apply(dict(variables), container.get_config(), output="labels_s2d")
    want = _jax_held_kernels(jfn)
    tfn = ts.build_s2d_apply(port, output="labels_s2d")
    assert tfn.s2d_levels == 3
    assert len(want) == tfn._n
    for i, (w, b) in enumerate(want):
        got_w = getattr(tfn, f"c{i}_w").permute(2, 3, 1, 0).numpy()  # OIHW -> HWIO
        got_b = getattr(tfn, f"c{i}_b").numpy()
        assert got_w.dtype == w.dtype and np.array_equal(got_w, w), i
        assert np.array_equal(got_b, b), i


def test_held_kernels_bit_equal_with_random_stats():
    container, variables, _, port = _config_models(CONFIGS[1])
    want = _jax_held_kernels(js.build_s2d_apply(variables, container.get_config()))
    tfn = ts.build_s2d_apply(port)
    for i, (w, b) in enumerate(want):
        assert np.array_equal(getattr(tfn, f"c{i}_w").permute(2, 3, 1, 0).numpy(), w), i
        assert np.array_equal(getattr(tfn, f"c{i}_b").numpy(), b), i


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"sn{c['start_neurons']}_pl{c['pool_layers']}_{c['h']}x{c['w']}")
def test_s2d_probs_match_jax_every_level_count(cfg):
    container, variables, x, port = _config_models(cfg)
    for levels in range(cfg["pool_layers"] + 1):
        want = np.asarray(
            jax.jit(js.build_s2d_apply(variables, container.get_config(), s2d_levels=levels))(x)
        )
        got = _run(ts.build_s2d_apply(port, s2d_levels=levels), x)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("output", ["labels", "labels_s2d"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"sn{c['start_neurons']}_pl{c['pool_layers']}_{c['h']}x{c['w']}")
def test_s2d_labels_equal_jax(cfg, output):
    container, variables, x, port = _config_models(cfg)
    want = np.asarray(
        jax.jit(js.build_s2d_apply(variables, container.get_config(), output=output))(x)
    )
    got = _run(ts.build_s2d_apply(port, output=output), x)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def test_maybe_build_and_odd_sizes_raise():
    container, variables, x, port = _config_models(CONFIGS[0])
    fn, div = ts.maybe_build_s2d_apply(port)
    assert div == 4 and fn.s2d_levels == 2
    fn1 = ts.build_s2d_apply(port, s2d_levels=1)
    with pytest.raises(ValueError, match="even spatial"):
        fn1(torch.zeros((1, 15, 24, 1)))
    with pytest.raises(ValueError, match="requires s2d_levels > 0"):
        ts.build_s2d_apply(port, s2d_levels=0, output="labels_s2d")
    with pytest.raises(ValueError, match="unknown output"):
        ts.build_s2d_apply(port, output="logits")
    # Odd conv_layers: the transform does not take the model.
    odd = get_model_class("unet")(
        input_channels=1, num_classes=3, image_height=16, image_width=16,
        start_neurons=4, pool_layers=2, conv_layers=1,
    ).build_model(device="cpu")
    assert ts.maybe_build_s2d_apply(odd) == (None, 1)
    assert ts.maybe_build_s2d_apply(torch.nn.Identity()) == (None, 1)


# ---------------------------------------------------------------------------
# s2d-domain tensor ops, public (B, H, W, C) layout
# ---------------------------------------------------------------------------


def test_s2d_ops_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 10, 3)).astype(np.float32)
    tx = torch.from_numpy(x)
    s = ts.s2d(tx)
    # Channel order (q_h, q_w, c), not pixel_unshuffle's (c, q_h, q_w).
    assert np.array_equal(s.numpy(), np.asarray(js.s2d(x)))
    assert not np.array_equal(
        s.numpy(),
        torch.nn.functional.pixel_unshuffle(tx.permute(0, 3, 1, 2), 2)
        .permute(0, 2, 3, 1)
        .numpy(),
    )
    assert torch.equal(ts.d2s(s), tx)
    assert np.array_equal(ts.d2s(s).numpy(), np.asarray(js.d2s(np.asarray(s))))
    assert np.array_equal(ts.phase_max_pool(s).numpy(), np.asarray(js.phase_max_pool(s.numpy())))
    small = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    assert np.array_equal(
        ts.phase_tile(torch.from_numpy(small)).numpy(), np.asarray(js.phase_tile(small))
    )
    b = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
    assert np.array_equal(
        ts.phase_concat(s, torch.from_numpy(b)).numpy(),
        np.asarray(js.phase_concat(s.numpy(), b)),
    )
    shifted = rng.normal(size=(2, 4, 6, 12)).astype(np.float32)
    assert np.array_equal(
        ts._mask_shifted(torch.from_numpy(shifted)).numpy(),
        np.asarray(js._mask_shifted(shifted)),
    )


def test_conv_block_space_matches_jax():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(3, 3, 2, 3)).astype(np.float32)
    # U -> S: (5, 7) blocks -> (6, 8); S -> U: (6, 8) -> (5, 7).
    for a_in, a_out, n_in, n_out in [(0, 1, (5, 7), (6, 8)), (1, 0, (6, 8), (5, 7))]:
        W2, e_h, e_w = js.transform_kernel(w, a_in, a_out)
        b4 = rng.normal(size=(W2.shape[-1],)).astype(np.float32)
        x = rng.normal(size=(2, *n_in, 8)).astype(np.float32)
        want = np.asarray(
            js._conv_block_space(x, W2, b4, e_h, e_w, *n_out, jnp.float32)
        )
        got = ts._conv_block_space(
            torch.from_numpy(x), torch.from_numpy(W2), torch.from_numpy(b4),
            e_h, e_w, *n_out,
        ).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
