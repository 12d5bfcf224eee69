"""The port's serving chain reproduces the JAX goldens from bridged weights.

The model is the goldens' (tests/test_goldens.py: start_neurons=4,
pool_layers=3, 64x96, ``PRNGKey(1234)``); its Flax variables cross into
the port through ``state_dict_from_flax``. Every integer key of
``pipeline_golden.json`` (exact ties), ``fused_fast_golden.json`` (fast
ties; JAX made it through the s2d labels forward, and the port meets it
through that forward and through the BN-folded one) and
``streaming_golden.json`` (10 B-scans, batch 4, the s2d path) must match
exactly; ``probs_mean`` within the goldens' own 2e-6.
"""

import functools
import json
import tracemalloc
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_torch.common.model_io import (
    LoadedModel,
    state_dict_from_flax,
)
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.models.unet import fold_batchnorm
from oct_image_segmentation_models_torch.ops import boundary as tb
from oct_image_segmentation_models_torch.ops.inference import (
    make_fused_pipeline,
    select_optimized_forward,
)
from oct_image_segmentation_models_torch.parallel.mesh import Mesh
from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

from synth import make_layered_sample
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

GOLDEN_DIR = Path(__file__).parent / "goldens"
H, W, C = 64, 96, 4


def _golden(name):
    return json.loads((GOLDEN_DIR / name).read_text())


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([make_layered_sample(rng, H, W, C)[0] for _ in range(n)])[
        ..., None
    ]


@functools.lru_cache(maxsize=None)
def _port_model():
    """The goldens' JAX U-Net, bridged into a port module on the CPU."""
    jax_container = jax_model_class("unet")(
        input_channels=1,
        num_classes=C,
        image_height=H,
        image_width=W,
        start_neurons=4,
        pool_layers=3,
    )
    jax_module = jax_container.build_model()
    # jit gives the same variables as the goldens' eager init, faster.
    variables = jax.jit(
        lambda key: jax_module.init(
            key, np.zeros((1, H, W, 1), np.float32), training=False
        )
    )(jax.random.PRNGKey(1234))
    config = jax_container.get_config()
    container = get_model_class("unet")(**config)
    module = container.build_model(device="cpu")
    module.load_state_dict(
        state_dict_from_flax(jax.tree_util.tree_map(np.asarray, dict(variables)))
    )
    return container, module


def test_pipeline_golden_exact_and_fast_ties():
    golden = _golden("pipeline_golden.json")
    container, module = _port_model()
    forward, kind = select_optimized_forward(module, optimize=False)
    assert kind == "parity"
    images = _images(4, 42)
    got = {}
    for tie, key in (("exact", "delineations"), ("fast", "delineations_fast")):
        pipeline = make_fused_pipeline(
            forward,
            container.get_preprocess_input_fn(),
            minpath_tie_parity=tie,
            device="cpu",
        )
        labels, maps, rows = pipeline(images)
        assert rows.dtype == torch.uint16 and labels.dtype == torch.uint8
        got[key] = rows.numpy().tolist()
    got["labels_sum"] = int(labels.to(torch.int64).sum())
    got["maps_nonzero"] = int((maps > 0).sum())
    got["maps_sum"] = int(maps.to(torch.int64).sum())
    masks = tb.create_area_mask(torch.tensor(got["delineations"], dtype=torch.float32), H)
    got["masks_sum"] = int(masks.to(torch.int64).sum())
    with torch.no_grad():
        probs = forward(torch.from_numpy(images).to(torch.float32) / 255.0)
    assert abs(round(float(probs.mean()), 6) - golden["probs_mean"]) < 2e-6
    for key, value in got.items():
        assert value == golden[key], key
    assert set(got) | {"probs_mean"} == set(golden)


def test_fused_fast_golden_folded_forward():
    golden = _golden("fused_fast_golden.json")
    container, module = _port_model()
    pipeline = make_fused_pipeline(
        fold_batchnorm(module),
        container.get_preprocess_input_fn(),
        minpath_tie_parity="fast",
        device="cpu",
    )
    labels, maps, rows = pipeline(_images(4, 42))
    assert int(labels.to(torch.int64).sum()) == golden["labels_sum"]
    assert int(maps.to(torch.int64).sum()) == golden["maps_sum"]
    assert rows.numpy().tolist() == golden["delineations"]


def test_fused_fast_golden_s2d_forward():
    golden = _golden("fused_fast_golden.json")
    container, module = _port_model()
    labels_fn, kind = select_optimized_forward(module)
    assert kind == "s2d"  # the goldens' config is s2d-eligible, as in JAX
    pipeline = make_fused_pipeline(
        None,
        container.get_preprocess_input_fn(),
        minpath_tie_parity="fast",
        labels_apply_fn=labels_fn,
        num_classes=C,
        device="cpu",
    )
    labels, maps, rows = pipeline(_images(4, 42))
    assert labels.shape == (4, H, W) and labels.dtype == torch.uint8
    assert maps.shape == (4, C - 1, H, W) and rows.dtype == torch.uint16
    assert int(labels.to(torch.int64).sum()) == golden["labels_sum"]
    assert int(maps.to(torch.int64).sum()) == golden["maps_sum"]
    assert rows.numpy().tolist() == golden["delineations"]
    # The s2d tail gives what the probability tail gives on the same labels.
    want_maps = tb.boundary_maps_from_labels(labels, C)
    assert torch.equal(maps, want_maps)
    _, no_maps, no_rows = make_fused_pipeline(
        None,
        container.get_preprocess_input_fn(),
        labels_apply_fn=labels_fn,
        num_classes=C,
        return_maps=False,
        with_graph_search=False,
        device="cpu",
    )(_images(1, 42))
    assert no_maps is None and no_rows is None


def test_selector_and_labels_fn_rejections():
    container, module = _port_model()
    labels_fn, _ = select_optimized_forward(module)
    with pytest.raises(ValueError, match="requires num_classes"):
        make_fused_pipeline(
            None, container.get_preprocess_input_fn(), labels_apply_fn=labels_fn,
            device="cpu",
        )
    # A U-Net the s2d transform does not take (odd conv_layers) gets the
    # BN-folded forward.
    odd = get_model_class("unet")(
        input_channels=1, num_classes=C, image_height=H, image_width=W,
        start_neurons=4, pool_layers=3, conv_layers=1,
    ).build_model(device="cpu")
    forward, kind = select_optimized_forward(odd)
    assert kind == "folded" and not forward.use_bn
    assert select_optimized_forward(odd, optimize=False) == (odd, "parity")
    # bfloat16 takes the s2d forward; where it has no fast path it raises,
    # as in JAX, which has no bfloat16 folded U-Net.
    labels_bf16, kind = select_optimized_forward(module, compute_dtype="bfloat16")
    assert kind == "s2d" and labels_bf16.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="no optimized inference variant"):
        select_optimized_forward(odd, compute_dtype="bfloat16")


def test_streaming_golden():
    golden = _golden("streaming_golden.json")
    container, module = _port_model()
    config = container.get_config()
    seg = VolumeSegmenter(
        LoadedModel("unet", module, config), config, batch_size=4, device="cpu"
    )
    assert seg.kind == "s2d"  # VolumeSegmenter's defaults, as in JAX
    labels, rows = seg.segment_volume(_images(10, 3))  # 2 full + remainder
    assert labels.shape == (10, H, W) and labels.dtype == np.uint8
    assert rows.shape == (10, C - 1, W) and rows.dtype == np.uint16
    assert int(labels.astype(np.int64).sum()) == golden["labels_sum"]
    assert rows.tolist() == golden["rows"]


def test_streaming_copies_no_more_than_one_batch_of_the_volume():
    """A 49-B-scan volume at batch 8: besides the returned arrays, which it
    allocates once, the host allocates no array larger than one batch (the
    padded last one), where padding the whole volume would copy 56
    B-scans. The pipeline is a stand-in, so that only the host path
    allocates."""
    container, module = _port_model()
    config = container.get_config()
    seg = VolumeSegmenter(LoadedModel("unet", module, config), config, batch_size=8, device="cpu")
    seg._pipeline = lambda x: (x[..., 0].clone(), None, x[:, : C - 1, :, 0].to(torch.uint16))
    volume = np.random.default_rng(4).integers(0, 256, (49, 256, 512, 1), dtype=np.uint8)
    seg.segment_volume(volume[:9])  # the ring and the interpreter's own caches
    batch_bytes = volume[:8].nbytes
    tracemalloc.start()
    try:
        base, _ = tracemalloc.get_traced_memory()
        labels, rows = seg.segment_volume(volume)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(labels, volume[..., 0])
    np.testing.assert_array_equal(rows, volume[:, : C - 1, :, 0])
    returned = labels.nbytes + rows.nbytes
    assert peak - base - returned < batch_bytes * 5 // 4, (peak - base, returned, batch_bytes)


def test_streaming_rejects_bad_input():
    container, module = _port_model()
    config = container.get_config()
    loaded = LoadedModel("unet", module, config)
    seg = VolumeSegmenter(loaded, config, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        seg.segment_volume(np.zeros((0, H, W, 1), np.uint8))
    with pytest.raises(ValueError, match="multiples of 8"):
        seg.segment_volume(np.zeros((2, H + 4, W, 1), np.uint8))
    with pytest.raises(ValueError, match="multiple of the node's 3 ranks"):
        VolumeSegmenter(loaded, config, batch_size=4, mesh=Mesh(1, 3, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="batch_size"):
        VolumeSegmenter(loaded, config, batch_size=0, device="cpu")
    # bfloat16 serves through the s2d forward; a U-Net the s2d transform
    # does not take has no bfloat16 path and raises, as in JAX.
    assert VolumeSegmenter(loaded, config, compute_dtype="bfloat16", device="cpu").kind == "s2d"
    odd_config = {**config, "conv_layers": 1}
    odd = get_model_class("unet")(**odd_config).build_model(device="cpu")
    with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
        VolumeSegmenter(
            LoadedModel("unet", odd, odd_config), odd_config, compute_dtype="bfloat16",
            device="cpu",
        )
    # Without graph search there are labels and no rows.
    labels, rows = VolumeSegmenter(
        loaded, config, batch_size=4, with_graph_search=False, device="cpu"
    ).segment_volume(_images(3, 5))
    assert labels.shape == (3, H, W) and rows is None
