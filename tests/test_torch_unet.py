"""The PyTorch U-Net and weights bridge against the JAX U-Net.

Inputs come from numpy with fixed seeds; weights come from the JAX
module's init and cross through ``state_dict_from_flax``. Tolerance:
probabilities within atol 1e-5 (both forwards are float32 on the CPU and
differ only in summation order; measured max |diff| ~6e-8) and argmax
equal on every pixel.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.common.model_io import save_model
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.models.unet import (
    UNetModule as JaxUNetModule,
    fold_batchnorm_variables as jax_fold,
)
from oct_image_segmentation_models_torch.common.model_io import (
    load_model,
    read_checkpoint,
    state_dict_from_flax,
)
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.models.unet import (
    UNetModule,
    fold_batchnorm,
    fold_batchnorm_variables,
)

from synth import make_layered_sample
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

PROB_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@functools.lru_cache(maxsize=None)
def _jax_unet_cached(h, w, c, input_channels, kw_items):
    container = jax_model_class("unet")(
        input_channels=input_channels,
        num_classes=c,
        image_height=h,
        image_width=w,
        **dict(kw_items),
    )
    module = container.build_model()
    # jit: the same variables as the eager init of tests/test_goldens.py,
    # compiled once instead of op by op.
    variables = jax.jit(
        lambda key: module.init(
            key, np.zeros((1, h, w, input_channels), np.float32), training=False
        )
    )(jax.random.PRNGKey(1234))
    return container, module, variables


def _jax_unet(h, w, c, input_channels=1, **kw):
    return _jax_unet_cached(h, w, c, input_channels, tuple(sorted(kw.items())))


def _randomize_bn(variables, seed):
    """Non-trivial BN statistics and affines, so folding is exercised."""
    rng = np.random.default_rng(seed)
    tree = _np_tree(variables)
    for name, layer in tree["params"].items():
        if "BatchNorm_0" in layer:
            bn = layer["BatchNorm_0"]
            bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
            bn["bias"] = rng.normal(0, 0.1, bn["bias"].shape).astype(np.float32)
            st = tree["batch_stats"][name]["BatchNorm_0"]
            st["mean"] = rng.normal(0, 0.1, st["mean"].shape).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    return tree


def _golden_images(n=4, h=64, w=96, c=4, seed=42):
    rng = np.random.default_rng(seed)
    return np.stack([make_layered_sample(rng, h, w, c)[0] for _ in range(n)])[
        ..., None
    ]


def _port(container, state_dict, use_bn=True):
    port = get_model_class("unet")(**container.get_config())
    module = port.build_model(device="cpu", use_bn=use_bn)
    module.load_state_dict(state_dict)
    return module


def _jax_probs(module, variables, images):
    apply = jax.jit(lambda v, x: module.apply(v, x, training=False))
    return np.asarray(apply(variables, images / 255.0))


def _forward(module, images):
    with torch.no_grad():
        return module(torch.from_numpy(images).to(torch.float32) / 255.0).numpy()


def _assert_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= PROB_ATOL, np.abs(got - want).max()
    flips = got.argmax(-1) != want.argmax(-1)
    if flips.any():
        top2 = np.sort(want, axis=-1)[..., -2:]
        margins = (top2[..., 1] - top2[..., 0])[flips]
        raise AssertionError(
            f"{int(flips.sum())} argmax flips at {np.argwhere(flips)[:10]}, "
            f"reference top-1/top-2 margins {margins[:10]}"
        )


@pytest.mark.parametrize("bn", ["init", "random"])
def test_unfolded_forward_matches_jax(bn):
    container, module, variables = _jax_unet(64, 96, 4, start_neurons=4, pool_layers=3)
    if bn == "random":
        variables = _randomize_bn(variables, 5)
    images = _golden_images()
    want = _jax_probs(module, variables, images)
    port = _port(container, state_dict_from_flax(_np_tree(variables)))
    _assert_close(_forward(port, images), want)


@pytest.mark.parametrize("bn", ["init", "random"])
def test_folded_forward_matches_jax(bn):
    container, _module, variables = _jax_unet(
        64, 96, 4, start_neurons=4, pool_layers=3
    )
    if bn == "random":
        variables = _randomize_bn(variables, 6)
    images = _golden_images()
    folded_jax = jax_fold(variables)
    want = _jax_probs(
        JaxUNetModule(num_classes=4, start_neurons=4, pool_layers=3, use_bn=False),
        folded_jax,
        images,
    )
    # Folding in the port gives bit-equal weights to folding in JAX.
    folded_sd = fold_batchnorm_variables(state_dict_from_flax(_np_tree(variables)))
    bridged = state_dict_from_flax(_np_tree(folded_jax))
    assert set(folded_sd) == set(bridged)
    for key in bridged:
        assert torch.equal(folded_sd[key], bridged[key]), key
    port = _port(container, bridged, use_bn=False)
    _assert_close(_forward(port, images), want)
    unfolded = _port(container, state_dict_from_flax(_np_tree(variables)))
    _assert_close(_forward(fold_batchnorm(unfolded), images), want)


def test_one_conv_layer_odd_sizes_matches_jax():
    # 36x44 with two pools: 18x22 then 9x11 at the bottleneck.
    h, w = 36, 44
    container, module, variables = _jax_unet(
        h, w, 3, input_channels=2, start_neurons=3, pool_layers=2, conv_layers=1
    )
    variables = _randomize_bn(variables, 7)
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (2, h, w, 2), dtype=np.uint8)
    want = _jax_probs(module, variables, images)
    port = _port(container, state_dict_from_flax(_np_tree(variables)))
    _assert_close(_forward(port, images), want)


def test_jax_checkpoint_reads_into_port(tmp_path):
    container, module, variables = _jax_unet(64, 96, 4, start_neurons=4, pool_layers=3)
    variables = _randomize_bn(variables, 8)
    path = tmp_path / "model.hdf5"
    save_model(path, "unet", container.get_config(), variables, opt_state_bytes=b"xy")
    name, config, variables_np = read_checkpoint(path)
    assert name == "unet"
    assert config == json_roundtrip(container.get_config())
    assert set(variables_np) == {"params", "batch_stats"}
    loaded = load_model(path, device="cpu")
    assert loaded.name == "unet" and loaded.output_classes == 4
    images = _golden_images(n=2)
    want = _jax_probs(module, variables, images)
    _assert_close(_forward(loaded.module, images), want)


def json_roundtrip(config):
    import json

    return json.loads(json.dumps(config))


def test_container_config_matches_jax():
    kw = dict(
        input_channels=1, num_classes=4, image_height=64, image_width=96,
        start_neurons=4, pool_layers=3,
    )
    jc = jax_model_class("unet")(**kw)
    pc = get_model_class("unet")(**kw)
    assert pc.get_config() == jc.get_config()
    assert pc.spatial_divisor == jc.spatial_divisor == 8
    x = np.arange(6, dtype=np.float32)
    assert np.array_equal(
        pc.get_preprocess_input_fn()(torch.from_numpy(x)).numpy(),
        np.asarray(jc.get_preprocess_input_fn()(x)),
    )


def test_registry_and_inference_only():
    from oct_image_segmentation_models_torch.models.deeplabv3plus import DeeplabV3Plus

    assert get_model_class("deeplabv3plus") is DeeplabV3Plus
    with pytest.raises(ValueError):
        get_model_class("resnet")
    # Train mode runs since training was ported: batch statistics update
    # the running ones, and the dropout mask follows the generator.
    module = UNetModule(input_channels=1, num_classes=3, start_neurons=2, pool_layers=1)
    module.train()
    x = torch.rand(2, 8, 8, 1, generator=torch.Generator().manual_seed(0))
    a = module(x, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(module.blocks[0].bn.running_var, torch.ones(2))
    b = module(x, generator=torch.Generator().manual_seed(1))
    c = module(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_seeded_init_is_reproducible_glorot():
    container = get_model_class("unet")(
        input_channels=1, num_classes=4, image_height=32, image_width=32,
        start_neurons=4, pool_layers=2,
    )
    a = container.build_model(generator=torch.Generator().manual_seed(3), device="cpu")
    b = container.build_model(generator=torch.Generator().manual_seed(3), device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    w = a.blocks[1].conv.weight.detach()  # 3x3, 4 -> 4 channels
    limit = np.sqrt(6.0 / (9 * (4 + 4)))
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.5 * limit
    assert float(a.blocks[1].conv.bias.detach().abs().max()) == 0.0
