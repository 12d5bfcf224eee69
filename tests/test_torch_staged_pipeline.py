"""The port's StagedPipeline against the JAX package's on the same images,
in both tie modes.

The model is the goldens' (start_neurons 4, pool_layers 3, 64x96, 4
classes, ``PRNGKey(1234)``), its Flax variables bridged into the port.
The probabilities agree within the goldens' 2e-6; labels, the one-hot
categorical, boundary maps, rows and area masks are bit-equal. The
geometric fallback and ``optimize=False`` reach the module as given, as
in JAX, and a dtype other than float32 raises.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops.inference import (
    StagedPipeline as JaxStagedPipeline,
)
from oct_image_segmentation_models_torch.common.model_io import state_dict_from_flax
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.ops.inference import StagedPipeline

from synth import make_layered_sample

H, W, C = 64, 96, 4
PROB_ATOL = 2e-6  # the goldens' tolerance


@functools.lru_cache(maxsize=None)
def _models():
    """The goldens' JAX U-Net and its port twin on the CPU."""
    jax_container = jax_model_class("unet")(
        input_channels=1, num_classes=C, image_height=H, image_width=W,
        start_neurons=4, pool_layers=3,
    )
    jax_module = jax_container.build_model()
    variables = jax.jit(
        lambda key: jax_module.init(key, np.zeros((1, H, W, 1), np.float32), training=False)
    )(jax.random.PRNGKey(1234))
    config = jax_container.get_config()
    container = get_model_class("unet")(**config)
    module = container.build_model(device="cpu")
    module.load_state_dict(
        state_dict_from_flax(jax.tree_util.tree_map(np.asarray, dict(variables)))
    )
    return jax_container, jax_module, variables, container, module


def _pipelines(tie="exact", optimize=True):
    jax_container, jax_module, variables, container, module = _models()
    jp = JaxStagedPipeline(
        jax_module,
        variables,
        jax_container.get_preprocess_input_fn(),
        model_config=jax_container.get_config(),
        optimize=optimize,
        minpath_tie_parity=tie,
    )
    tp = StagedPipeline(
        module,
        container.get_preprocess_input_fn(),
        optimize=optimize,
        minpath_tie_parity=tie,
        device="cpu",
    )
    return jp, tp


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([make_layered_sample(rng, H, W, C)[0] for _ in range(n)])[..., None]


@pytest.mark.parametrize("tie", ["exact", "fast"])
def test_stages_match_jax(tie):
    jp, tp = _pipelines(tie)
    assert tp.kind == "s2d" and tp._s2d_div == jp._s2d_div == 8
    images = _images(3, 42)
    want_probs = np.asarray(jp.predict_probs(images))
    probs = tp.predict_probs(images)
    assert probs.dtype == torch.float32 and probs.shape == (3, H, W, C)
    np.testing.assert_allclose(probs.numpy(), want_probs, rtol=0, atol=PROB_ATOL)

    want = [np.asarray(a) for a in jp.convert(want_probs)]
    got = tp.convert(probs)
    for name, g, w in zip(("labels", "categorical", "maps"), got, want):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[1].dtype == torch.float32 and got[2].shape == (3, C - 1, H, W)

    want_rows, want_masks = (np.asarray(a) for a in jp.graph_search(want[2]))
    rows, masks = tp.graph_search(got[2])
    assert rows.dtype == torch.uint16 and masks.dtype == torch.uint8
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    np.testing.assert_array_equal(masks.numpy(), want_masks)


def test_fallback_and_optimize_off_reach_the_module_as_jax_does():
    """Images whose H or W do not divide the s2d factor, and every image
    without ``optimize``, go through the module as given (JAX: the plain
    ``module.apply``)."""
    _, _, _, container, module = _models()
    images = _images(2, 5)
    x = torch.from_numpy(images).to(torch.float32) / 255.0
    with torch.no_grad():
        plain = module(x).numpy()

    jp, tp = _pipelines()
    # No U-Net input reaches the fallback on its own (its dims divide
    # 2**pool_layers, a multiple of the s2d factor), so raise the factor.
    jp._s2d_div = tp._s2d_div = 64
    fallback = tp.predict_probs(images).numpy()
    np.testing.assert_array_equal(fallback, plain)
    np.testing.assert_allclose(
        fallback, np.asarray(jp.predict_probs(images)), rtol=0, atol=PROB_ATOL
    )

    jp_off, tp_off = _pipelines(optimize=False)
    assert tp_off.kind == "parity" and tp_off._s2d is None
    off = tp_off.predict_probs(images).numpy()
    np.testing.assert_array_equal(off, plain)
    np.testing.assert_allclose(
        off, np.asarray(jp_off.predict_probs(images)), rtol=0, atol=PROB_ATOL
    )


def test_non_float32_dtype_raises():
    """bfloat16 runs the s2d forward; where it would fall back to the
    float32 module (an image that misses the s2d factor) it raises, as in
    JAX (``test_torch_bf16.py`` holds the probabilities against JAX's)."""
    _, _, _, container, module = _models()
    pipeline = StagedPipeline(
        module, container.get_preprocess_input_fn(), compute_dtype="bfloat16",
        device="cpu",
    )
    assert pipeline.kind == "s2d" and pipeline._s2d.compute_dtype == torch.bfloat16
    probs = pipeline.predict_probs(np.zeros((1, H, W, 1), np.uint8))
    assert probs.dtype == torch.float32 and probs.shape == (1, H, W, C)
    with pytest.raises(ValueError, match="float32"):
        pipeline.predict_probs(np.zeros((1, H + 4, W, 1), np.uint8))


def test_numpy_utils_match_jax():
    """The numpy-facing wrappers of ``common/utils.py`` give JAX's values
    and dtypes."""
    from oct_image_segmentation_models_tpu.common import utils as jax_utils
    from oct_image_segmentation_models_torch.common import utils

    rng = np.random.default_rng(0)
    probs = rng.random((2, 16, 24, C)).astype(np.float32)
    probs[0, :2] = 0.25  # ties take the first class
    for binarize in (True, False):
        got = utils.perform_argmax(probs, bin=binarize)
        want = jax_utils.perform_argmax(probs, bin=binarize)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    categorical = jax_utils.perform_argmax(probs)[1]
    for bg_ilm, bg_csi in ((True, False), (False, True)):
        got = utils.convert_predictions_to_maps_semantic(categorical, bg_ilm, bg_csi)
        want = jax_utils.convert_predictions_to_maps_semantic(categorical, bg_ilm, bg_csi)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        utils.convert_maps_uint8(probs), jax_utils.convert_maps_uint8(probs)
    )
