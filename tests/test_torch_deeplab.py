"""The port's DeepLabV3+ (ResNet50 backbone, DSPP, decoder) and its serving
paths against the JAX package's, on the CPU.

The weights are JAX's own: one jitted ``module.init`` with ``PRNGKey(99)``
at 64x64, the init of ``tests/goldens/deeplab_pipeline_golden.json``, bridged
with ``state_dict_from_flax`` (Flax's init draws do not depend on the input
size, so the same weights serve every shape here). "Trained" statistics
are a seeded draw of running means in [-0.5, 0.5] and variances in
[0.5, 1.5].

Tolerances: probabilities atol 1e-5 with equal argmax (measured 5e-6:
``jax.image.resize`` and ``F.interpolate`` agree to float32 rounding, not
bit for bit); folded weights bit-equal; ``_resize_bilinear`` atol 1e-6;
the preprocess, the bridge, the golden and the min-path outputs bit-equal.
"""

import json
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.models import deeplabv3plus as jax_deeplab
from oct_image_segmentation_models_tpu.ops.inference import StagedPipeline as JaxStagedPipeline
from oct_image_segmentation_models_tpu.prediction.prediction import (
    run_pipeline as jax_run_pipeline,
)
from oct_image_segmentation_models_torch.common import model_io
from oct_image_segmentation_models_torch.evaluation import (
    EvaluationParameters,
    EvaluationSaveParams,
    evaluate_model,
)
from oct_image_segmentation_models_torch.models import deeplabv3plus as port_deeplab
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.models.resnet import ResNet50Backbone
from oct_image_segmentation_models_torch.ops.inference import (
    StagedPipeline,
    make_fused_pipeline,
    select_optimized_forward,
)
from oct_image_segmentation_models_torch.prediction.prediction import run_pipeline
from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

from synth import make_dataset, make_layered_sample
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

GOLDEN = Path(__file__).parent / "goldens" / "deeplab_pipeline_golden.json"

C = 4
GOLDEN_HW = 64
PROB_ATOL = 1e-5
RESIZE_ATOL = 1e-6


def _config(h, w):
    return dict(input_channels=3, num_classes=C, image_height=h, image_width=w)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def jax_model():
    """(JAX module, variables as numpy): the golden's init."""
    module = jax_model_class("deeplabv3plus")(**_config(GOLDEN_HW, GOLDEN_HW)).build_model()
    variables = jax.jit(
        lambda k: module.init(k, jnp.zeros((1, GOLDEN_HW, GOLDEN_HW, 3)), training=False)
    )(jax.random.PRNGKey(99))
    return module, _np_tree(variables)


def _trained(variables):
    """``variables`` with seeded running statistics that are not 0/1."""
    rng = np.random.default_rng(5)

    def draw(path, a):
        if path[-1].key == "mean":
            return rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map_with_path(draw, variables["batch_stats"]),
    }


def _port(variables, h=GOLDEN_HW, w=GOLDEN_HW):
    module = get_model_class("deeplabv3plus")(**_config(h, w)).build_model(device="cpu")
    module.load_state_dict(model_io.state_dict_from_flax(variables))
    return module


def _images(n, h, w, seed):
    rng = np.random.default_rng(seed)
    gray = np.stack([make_layered_sample(rng, h, w, C)[0] for _ in range(n)])
    return np.repeat(gray[..., None], 3, axis=-1)


def _preprocess():
    return get_model_class("deeplabv3plus")(**_config(8, 8)).get_preprocess_input_fn()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


_apply = {}


def _jax_apply(module, variables, x):
    """JAX's eval-mode forward, one compile per module kind and shape."""
    key = (module.use_bn, x.shape)
    if key not in _apply:
        _apply[key] = jax.jit(lambda v, x: module.apply(v, x, training=False))
    return np.asarray(_apply[key](variables, x))


@pytest.mark.parametrize("folded", [False, True])
def test_bridge_round_trips_bit_for_bit(jax_model, folded):
    _, variables = jax_model
    if folded:
        variables = _np_tree(jax_deeplab.fold_deeplab_batchnorm_variables(variables))
    sd = model_io.state_dict_from_flax(variables)
    module = get_model_class("deeplabv3plus")(**_config(64, 64)).build_model(
        device="cpu", use_bn=not folded
    )
    assert set(sd) == set(module.state_dict())
    assert model_io.is_folded(sd) == folded
    back = model_io.flax_from_state_dict(sd)
    want, got = _flat(variables), _flat(back)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    again = model_io.state_dict_from_flax(back)
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


@pytest.mark.parametrize("stats", ["init", "trained"])
def test_forward_matches_jax_at_an_odd_stride(jax_model, stats):
    """48x64: the stride-16 tap is 3x4 and the stride-4 tap 12x16."""
    jmod, variables = jax_model
    if stats == "trained":
        variables = _trained(variables)
    x = _preprocess()(_images(2, 48, 64, seed=1))
    want = _jax_apply(jmod, variables, x)
    with torch.no_grad():
        got = _port(variables, 48, 64)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 48, 64, C)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_backbone_taps_and_pruned_tail():
    backbone = ResNet50Backbone(3)
    names = {n for n, _ in backbone.named_children()}
    assert "conv4_block6_2_conv" in names and "conv4_block6_3_conv" not in names
    assert not any(n.startswith("conv5") for n in names)
    with torch.no_grad():
        tap, low = backbone(torch.rand(1, 3, 48, 64, generator=torch.Generator().manual_seed(0)))
    assert tap.shape == (1, 256, 3, 4) and low.shape == (1, 64, 12, 16)


@pytest.mark.parametrize("stats", ["init", "trained"])
def test_folded_weights_and_forward_match_jax(jax_model, stats):
    _, variables = jax_model
    if stats == "trained":
        variables = _trained(variables)
    want = model_io.state_dict_from_flax(
        _np_tree(jax_deeplab.fold_deeplab_batchnorm_variables(variables))
    )
    folded = port_deeplab.fold_batchnorm(_port(variables))
    assert not folded.use_bn and port_deeplab.fold_batchnorm(folded) is folded
    got = folded.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    apply_fn, fvars = jax_deeplab.maybe_build_folded_apply(
        jax_deeplab.DeeplabV3PlusModule(num_classes=C), variables
    )
    x = _preprocess()(_images(2, 64, 64, seed=2))
    want_p = np.asarray(jax.jit(apply_fn)(fvars, x))
    with torch.no_grad():
        got_p = folded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_p, want_p, atol=PROB_ATOL)
    assert np.array_equal(got_p.argmax(-1), want_p.argmax(-1))


def test_fused_pipeline_reproduces_the_golden(jax_model):
    """``tests/goldens/deeplab_pipeline_golden.json`` exactly, through the
    folded forward, the probability tail and the min-path, fast ties."""
    _, variables = jax_model
    container = get_model_class("deeplabv3plus")(**_config(GOLDEN_HW, GOLDEN_HW))
    forward, kind = select_optimized_forward(_port(variables))
    assert kind == "folded" and not forward.use_bn
    pipeline = make_fused_pipeline(
        forward, container.get_preprocess_input_fn(), minpath_tie_parity="fast", device="cpu"
    )

    # the golden's B-scans: ``tests/test_goldens.py::_tiny_images(2, 64, 64,
    # 4, seed=11)`` repeated to 3 channels
    rng = np.random.default_rng(11)
    gray = np.stack([make_layered_sample(rng, GOLDEN_HW, GOLDEN_HW, C)[0] for _ in range(2)])
    images = np.repeat(gray[..., None], 3, axis=-1)
    labels, maps, rows = pipeline(torch.from_numpy(images))
    golden = json.loads(GOLDEN.read_text())
    assert int(labels.numpy().astype(np.int64).sum()) == golden["labels_sum"]
    assert int(maps.numpy().astype(np.int64).sum()) == golden["maps_sum"]
    assert rows.numpy().tolist() == golden["delineations"]


def test_staged_pipeline_matches_jax(jax_model):
    """StagedPipeline folds a DeepLab's BatchNorm, as JAX's does:
    probabilities within 1e-5; labels, maps, rows and masks bit-equal, in
    both tie modes."""
    jmod, variables = jax_model
    variables = _trained(variables)
    prep = _preprocess()
    jprep = jax_model_class("deeplabv3plus")(**_config(64, 64)).get_preprocess_input_fn()
    images = _images(2, 64, 64, seed=3)
    want = None
    for tie in ("exact", "fast"):
        jp = JaxStagedPipeline(jmod, variables, jprep, minpath_tie_parity=tie)
        tp = StagedPipeline(_port(variables), prep, minpath_tie_parity=tie, device="cpu")
        assert tp.kind == "folded"
        if want is None:  # one JAX forward compile: the tie mode is the graph stage's
            want = np.asarray(jp.predict_probs(images))
            want_converted = [np.asarray(a) for a in jp.convert(want)]
        got = tp.predict_probs(torch.from_numpy(images))
        np.testing.assert_allclose(got.numpy(), want, atol=PROB_ATOL)
        converted = tp.convert(got)
        for w, g in zip(want_converted, converted):
            assert np.array_equal(w, g.numpy())
        maps = converted[2]
        for w, g in zip(jp.graph_search(maps.numpy()), tp.graph_search(maps)):
            assert np.array_equal(np.asarray(w), g.numpy()), tie
    unoptimized = StagedPipeline(_port(variables), prep, optimize=False, device="cpu")
    assert unoptimized.kind == "parity" and unoptimized._module.use_bn


def test_run_pipeline_and_volume_segmenter_serve_a_checkpoint(jax_model, tmp_path):
    """A DeepLab checkpoint through ``run_pipeline`` (against JAX's) and
    ``VolumeSegmenter`` (against the fused pipeline), 3-channel B-scans,
    spatial divisor 4, a batch remainder."""
    jmod, variables = jax_model
    variables = _trained(variables)
    config = _config(64, 64)
    path = tmp_path / "deeplab.hdf5"
    model_io.save_model(path, "deeplabv3plus", config, _port(variables).state_dict())
    loaded, loaded_config = model_io.load_model_and_config(path, device="cpu")
    assert loaded.name == "deeplabv3plus" and loaded_config == config
    images = _images(3, 64, 64, seed=4)
    got = run_pipeline(loaded, config, images, 2, True, minpath_tie_parity="fast", device="cpu")
    from oct_image_segmentation_models_tpu.common.model_io import load_model_and_config

    jax_loaded, _ = load_model_and_config(path)
    want = jax_run_pipeline(jax_loaded, config, images, 2, True, minpath_tie_parity="fast")
    for key in ("predicted_labels", "boundary_maps", "gs_pred_segs", "gs_masks"):
        assert np.array_equal(got[key], np.asarray(want[key])), key

    seg = VolumeSegmenter(loaded, config, batch_size=2, device="cpu")
    assert seg.kind == "folded"
    labels, rows = seg.segment_volume(images)
    pipe = make_fused_pipeline(
        port_deeplab.fold_batchnorm(loaded.module), _preprocess(), minpath_tie_parity="fast",
        device="cpu",
    )
    want_labels, _, want_rows = pipe(torch.from_numpy(images))
    assert np.array_equal(labels, want_labels.numpy())
    assert np.array_equal(rows, want_rows.numpy())
    assert np.array_equal(labels, got["predicted_labels"])
    with pytest.raises(ValueError, match="multiples of 4"):
        seg.segment_volume(_images(1, 62, 64, seed=5))


def test_evaluate_model_runs_a_deeplab_checkpoint(jax_model, tmp_path):
    _, variables = jax_model
    ds = make_dataset(tmp_path / "ds.hdf5", n_train=2, n_val=2, n_test=2, h=48, w=64,
                      num_classes=C, seed=7)
    with h5py.File(ds, "r+") as f:
        images = f["test_images"][:]
        del f["test_images"]
        f["test_images"] = np.repeat(images, 3, axis=-1)
    path = tmp_path / "deeplab.hdf5"
    model_io.save_model(path, "deeplabv3plus", _config(48, 64), _port(variables).state_dict())
    evaluate_model(EvaluationParameters(
        model_path=path, mlflow_tracking_uri=None, mlflow_run_uuid=None,
        test_dataset_path=ds, save_foldername=tmp_path / "eval",
        save_params=EvaluationSaveParams(), graph_search=True,
        metrics=["dice_coef_macro"], batch_size=2, device="cpu",
    ))
    assert any((tmp_path / "eval").rglob("*.hdf5"))


@pytest.mark.parametrize(
    "shape,size",
    [
        ((2, 3, 4, 256), (12, 16)),  # DSPP -> (H//4, W//4) at 48x64
        ((2, 12, 16, 256), (48, 64)),  # decoder -> (H, W) at 48x64
        ((2, 4, 4, 256), (16, 16)),  # at 64x64
        ((2, 1, 1, 256), (3, 4)),  # the pooled branch's broadcast
        ((1, 5, 7, 3), (20, 28)),  # odd sizes
        ((1, 3, 5, 2), (13, 21)),  # a factor that is not an integer
    ],
)
def test_resize_matches_jax_image_resize(shape, size):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_deeplab._resize_bilinear(jnp.asarray(x), *size))
    got = port_deeplab.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), *size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=RESIZE_ATOL)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
@pytest.mark.parametrize("channels", [3, 1])
def test_preprocess_on_numpy_and_tensors_bit_equal_to_jax(dtype, channels):
    x = np.random.default_rng(1).uniform(0, 255, (2, 8, 12, channels)).astype(dtype)
    want = np.asarray(
        jax_model_class("deeplabv3plus")(**_config(8, 12)).get_preprocess_input_fn()(x)
    )
    fn = _preprocess()
    got_np = fn(x)
    got_t = fn(torch.from_numpy(x))
    assert isinstance(got_np, np.ndarray) and got_np.dtype == np.float32
    assert got_t.dtype == torch.float32
    assert np.array_equal(got_np, want) and np.array_equal(got_t.numpy(), want)
    # the host result goes to a tensor as it is (no negative strides)
    assert torch.equal(torch.from_numpy(got_np), got_t)


def test_init_follows_the_stated_distributions():
    module = get_model_class("deeplabv3plus")(**_config(64, 64)).build_model(
        generator=torch.Generator().manual_seed(0), device="cpu"
    )
    again = get_model_class("deeplabv3plus")(**_config(64, 64)).build_model(
        generator=torch.Generator().manual_seed(0), device="cpu"
    )
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in module.state_dict().items())
    assert sum(p.numel() for p in module.parameters()) == 11_820_388
    for name, conv in module.named_modules():
        if not isinstance(conv, torch.nn.Conv2d):
            continue
        w = conv.weight.detach().double()
        out_ch, in_ch, kh, kw = w.shape
        if name.startswith("resnet50.") or name == "head":  # glorot uniform
            limit = np.sqrt(6.0 / (kh * kw * (in_ch + out_ch)))
            assert float(w.abs().max()) <= limit
            want_std = limit / np.sqrt(3.0)
        else:  # flax he_normal: truncated at 2 std, rescaled
            std = np.sqrt(2.0 / (kh * kw * in_ch))
            assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
            want_std = std
        assert abs(float(w.std()) / want_std - 1) < 0.05, name
        assert abs(float(w.mean())) < 4 * want_std / np.sqrt(w.numel()), name
        if conv.bias is not None:
            assert not conv.bias.any(), name
    for name, bn in module.named_modules():
        if isinstance(bn, port_deeplab.BatchNorm):
            assert bn.weight.eq(1).all() and not bn.bias.any() and not bn.running_mean.any()
            assert bn.running_var.eq(1).all()
            assert bn.eps == (1.001e-5 if name.startswith("resnet50.") else 1e-3), name


@pytest.mark.parametrize(
    "extra",
    [{}, {"dtype": "bfloat16"}, {"pretrained_weights": "resnet50.h5"}],
)
def test_config_round_trip_and_unported_options(extra):
    kw = {**_config(48, 64), **extra}
    jc = jax_model_class("deeplabv3plus")(**kw)
    pc = get_model_class("deeplabv3plus")(**kw)
    assert pc.get_config() == jc.get_config()
    assert get_model_class("deeplabv3plus")(**pc.get_config()).get_config() == pc.get_config()
    assert pc.spatial_divisor == jc.spatial_divisor == 4
    if "dtype" in extra:
        # float32 parameters, a bfloat16 conv stack, a float32 head
        module = pc.build_model(device="cpu")
        assert module.compute_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in module.parameters())
        with torch.no_grad():
            out = module(torch.zeros(1, 48, 64, 3))
        assert out.dtype == torch.float32 and out.shape == (1, 48, 64, C)
    elif extra:
        # The Keras ResNet50 import is ported: the container builds, and
        # the named file is read when the weights are applied.
        module = pc.build_model(device="cpu")
        with pytest.raises(FileNotFoundError, match="resnet50.h5"):
            pc.apply_pretrained_weights(module.state_dict())
