"""The port's bfloat16 serving against the JAX package's, on the CPU.

Weights are JAX's own (jitted ``module.init``), bridged with
``state_dict_from_flax``; inputs come from numpy with fixed seeds. The
sizes are the goldens' (64x96, start_neurons=4, pool_layers=3) and, for
DeepLabV3+, 48x64.

Tolerances, each measured on the CPU and stated here:

- one conv block and one BatchNorm on the same bfloat16 input: at least
  99.9% of the outputs bit-equal and the rest one bfloat16 ulp apart
  (measured: 99.99% bit-equal); the batch statistics within 1e-6 relative;
- the s2d bfloat16 forward against JAX's ``build_s2d_apply(dtype=
  bfloat16)``: probabilities within ``S2D_PROB_ATOL`` = 1e-3 (measured
  6e-8 and 2.6e-4 on two batches: a rare one-ulp flip in a conv carries
  to the head) and argmax equal on >= 99% of the pixels (measured 100%);
  the bfloat16 pipeline reproduces ``bf16_pipeline_golden.json`` exactly;
- the folded DeepLabV3+ bfloat16 forward against JAX's
  ``maybe_build_folded_apply(dtype=bfloat16)``: probabilities within
  ``DEEPLAB_PROB_ATOL`` = 5e-2 and under JAX's own bfloat16-to-float32
  gap (measured 0.035 against 0.041), argmax equal on >= 99% (measured
  99.4%). Single convs agree bit for bit but for one ulp on 0.01% of the
  outputs (the float32 sums run in another order); past 128 channels the
  ResNet50's convs flip more roundings and carry them down, as they carry
  bfloat16's own rounding;
- the reference's bfloat16 budget (JAX ``tests/test_s2d_unet.py``) on a
  the goldens' U-Net trained 30 Adam steps from its JAX init: bfloat16
  labels agree with float32 labels on > 99.5% of the pixels and the
  min-path rows within 0.05 px mean (measured 99.78% and 0.028 px);
- the bfloat16 export artifact, written by the CLI from a JAX checkpoint
  whose config says ``dtype="bfloat16"``, serves bit-equal to eager
  bfloat16 serving.

Training in bfloat16, and a JAX bfloat16-trained checkpoint served by the
port, are in ``test_torch_bf16_training.py``.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.common.model_io import save_model as jax_save_model
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.models.deeplabv3plus import maybe_build_folded_apply
from oct_image_segmentation_models_tpu.models.unet import ConvBlock as JaxConvBlock
from oct_image_segmentation_models_tpu.ops.inference import StagedPipeline as JaxStagedPipeline
from oct_image_segmentation_models_torch import cli
from oct_image_segmentation_models_torch.common import model_io
from oct_image_segmentation_models_torch.common.export import load_exported_pipeline
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.models.unet import ConvBlock
from oct_image_segmentation_models_torch.ops import boundary as tb
from oct_image_segmentation_models_torch.ops import minpath as tmp
from oct_image_segmentation_models_torch.ops.bn_refresh import compute_precise_batch_stats
from oct_image_segmentation_models_torch.ops.inference import (
    StagedPipeline,
    make_fused_pipeline,
    select_optimized_forward,
)
from oct_image_segmentation_models_torch.ops.losses import custom_loss_objects
from oct_image_segmentation_models_torch.ops.s2d_unet import build_s2d_apply, d2s
from oct_image_segmentation_models_torch.parallel import train_step as tts

from synth import make_layered_sample
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

GOLDEN = Path(__file__).parent / "goldens" / "bf16_pipeline_golden.json"
H, W, C = 64, 96, 4
DH, DW = 48, 64
BIT_EQUAL_MIN = 0.999
STAT_RTOL = 1e-6
S2D_PROB_ATOL = 1e-3
DEEPLAB_PROB_ATOL = 5e-2
MIN_AGREEMENT = 0.99
BUDGET_AGREEMENT, BUDGET_MAE = 0.995, 0.05


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _images(n, h, w, c, seed, channels=1):
    rng = np.random.default_rng(seed)
    gray = np.stack([make_layered_sample(rng, h, w, c)[0] for _ in range(n)])[..., None]
    return np.repeat(gray, channels, axis=-1)


def _random_stats(variables, seed):
    """``variables`` with seeded running statistics that are not 0/1."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key == "mean":
            return rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map_with_path(draw, variables["batch_stats"]),
    }


@functools.lru_cache(maxsize=None)
def _golden_unet():
    """(JAX module, variables, config) of the goldens' U-Net."""
    container = jax_model_class("unet")(
        input_channels=1, num_classes=C, image_height=H, image_width=W,
        start_neurons=4, pool_layers=3,
    )
    module = container.build_model()
    variables = _np_tree(
        jax.jit(
            lambda k: module.init(k, np.zeros((1, H, W, 1), np.float32), training=False)
        )(jax.random.PRNGKey(1234))
    )
    return module, variables, container.get_config()


def _unet(random_stats: bool):
    """(JAX module, variables, config, port module) of the goldens' U-Net,
    with seeded running statistics if ``random_stats``."""
    module, variables, config = _golden_unet()
    if random_stats:
        variables = _random_stats(variables, 3)
    port = get_model_class("unet")(**config).build_model(device="cpu")
    port.load_state_dict(model_io.state_dict_from_flax(variables))
    return module, variables, config, port


def test_bf16_precision_context_sets_and_restores_the_switches():
    """``bfloat16_precision`` turns cuBLAS's bfloat16 split-K reduction
    and TF32 off and restores the caller's settings; ``precision`` picks
    the context by dtype."""
    from oct_image_segmentation_models_torch import _device

    matmul = torch.backends.cuda.matmul
    prev = (matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32)
    matmul.allow_bf16_reduced_precision_reduction = matmul.allow_tf32 = True
    try:
        with _device.precision("bfloat16"):
            assert not matmul.allow_bf16_reduced_precision_reduction
            assert not matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert matmul.allow_bf16_reduced_precision_reduction and matmul.allow_tf32
        with _device.precision(torch.float32):
            assert matmul.allow_bf16_reduced_precision_reduction and not matmul.allow_tf32
    finally:
        matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32 = prev
    assert _device.compute_dtype("bfloat16") == _device.compute_dtype(torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _device.compute_dtype("float16")


def _bits(a) -> np.ndarray:
    """bfloat16 values as their int16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


@pytest.mark.parametrize("batch_stats", [False, True], ids=["running", "batch"])
def test_conv_block_and_batchnorm_match_flax_in_bf16(batch_stats):
    """One conv block and its BatchNorm on the same bfloat16 input, the
    working type of both: the outputs bit-equal but for one ulp on a few
    elements, the batch statistics float32 and within 1e-6."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, H, W, 8)).astype(np.float32), jnp.bfloat16)
    block = JaxConvBlock(8, (3, 3), dtype=jnp.bfloat16)
    variables = _np_tree(jax.jit(lambda k: block.init(k, x, False))(jax.random.PRNGKey(0)))
    variables = _random_stats(variables, 1)
    variables["params"]["Conv_0"]["bias"] = rng.normal(0, 0.1, 8).astype(np.float32)
    out, mut = jax.jit(
        lambda v, x: block.apply(v, x, batch_stats, mutable=["batch_stats"])
    )(variables, x)
    assert out.dtype == jnp.bfloat16

    port = ConvBlock(8, 8, (3, 3), use_bn=True)
    state = model_io.state_dict_from_flax({"params": {"ConvBlock_0": variables["params"]},
                                           "batch_stats": {"ConvBlock_0": variables["batch_stats"]}})
    port.load_state_dict({k.removeprefix("blocks.0."): v for k, v in state.items()})
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    with torch.no_grad():
        got = port(xt.permute(0, 3, 1, 2), batch_stats).permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    ulps = np.abs(_bits(got) - _bits(out))
    assert (ulps == 0).mean() >= BIT_EQUAL_MIN, (ulps == 0).mean()
    assert ulps.max() <= 1
    bn = port.bn
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    want = mut["batch_stats"]["BatchNorm_0"]
    for mine, theirs in ((bn.running_mean, want["mean"]), (bn.running_var, want["var"])):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=STAT_RTOL, atol=1e-7)


def test_s2d_forward_and_staged_pipeline_match_jax():
    """JAX's staged bfloat16 forward is ``build_s2d_apply(dtype=bfloat16)``
    after the preprocess; the port's ``S2DUNet`` and ``StagedPipeline``
    are held against it. Both refuse an image that misses the s2d factor
    rather than run float32."""
    jmod, variables, config, port = _unet(True)
    theirs = JaxStagedPipeline(
        jmod, variables, jax_model_class("unet")(**config).get_preprocess_input_fn(),
        model_config=config, compute_dtype="bfloat16",
    )
    images = _images(4, H, W, C, seed=11)
    want = np.asarray(theirs.predict_probs(images))
    fn = build_s2d_apply(port, dtype="bfloat16")
    assert fn.compute_dtype == torch.bfloat16 and fn.c0_w.dtype == torch.bfloat16
    with torch.no_grad():
        got = fn(torch.from_numpy(images / 255.0).float()).numpy()
    assert got.dtype == np.float32 and got.shape == (4, H, W, C)
    pre = get_model_class("unet")(**config).get_preprocess_input_fn()
    mine = StagedPipeline(port, pre, compute_dtype="bfloat16", device="cpu")
    np.testing.assert_array_equal(mine.predict_probs(images).numpy(), got)
    np.testing.assert_allclose(got, want, atol=S2D_PROB_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= MIN_AGREEMENT
    # 68 rows miss the s2d factor 8.
    odd = np.zeros((1, H + 4, W, 1), np.uint8)
    for pipeline in (mine, theirs):
        with pytest.raises(ValueError, match="requires the s2d fast path"):
            pipeline.predict_probs(odd)


def test_bf16_pipeline_reproduces_the_golden():
    """The goldens' init weights through the fused bfloat16 pipeline."""
    golden = json.loads(GOLDEN.read_text())
    _, _, config, port = _unet(False)
    labels_fn, kind = select_optimized_forward(port, compute_dtype="bfloat16")
    assert kind == "s2d" and labels_fn.compute_dtype == torch.bfloat16
    pipeline = make_fused_pipeline(
        None, get_model_class("unet")(**config).get_preprocess_input_fn(),
        minpath_tie_parity="fast", labels_apply_fn=labels_fn, num_classes=C, device="cpu",
    )
    labels, maps, rows = pipeline(_images(4, H, W, C, seed=7))
    assert int(labels.to(torch.int64).sum()) == golden["labels_sum"]
    assert int(maps.to(torch.int64).sum()) == golden["maps_sum"]
    assert rows.numpy().tolist() == golden["delineations"]


def test_bf16_is_refused_where_jax_refuses_it():
    """No fast path, no bfloat16: ``optimize=False`` and a U-Net the s2d
    transform does not take raise, in the port as in JAX."""
    _, _, config, port = _unet(False)
    with pytest.raises(ValueError, match="optimize=False"):
        select_optimized_forward(port, compute_dtype="bfloat16", optimize=False)
    odd = get_model_class("unet")(**{**config, "conv_layers": 1}).build_model(device="cpu")
    assert select_optimized_forward(odd)[1] == "folded"  # float32 folds it
    with pytest.raises(ValueError, match="no optimized inference variant"):
        select_optimized_forward(odd, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="compute dtype"):
        select_optimized_forward(port, compute_dtype="float16")


def _trained_tiny_unet():
    """The goldens' U-Net from its jitted JAX init, trained 30 float32
    Adam steps (batch 4, Dice loss) by the port's train step on synthetic
    B-scans, with precise BatchNorm statistics."""
    _, variables, config = _golden_unet()
    module = get_model_class("unet")(**config).build_model(device="cpu")
    module.load_state_dict(model_io.state_dict_from_flax(variables))
    rng = np.random.default_rng(3)
    samples = [make_layered_sample(rng, H, W, C) for _ in range(16)]
    x = torch.from_numpy(np.stack([s[0] for s in samples])[..., None] / 255.0).float()
    y = torch.from_numpy(np.stack([s[1] for s in samples])[..., None].astype(np.int64))
    loss = custom_loss_objects["dice_loss_macro"]["function"](num_classes=C, is_y_true_sparse=True)
    state = tts.create_train_state(module, tts.adam(5e-3))
    step = tts.make_train_step(module, loss, lambda labels, out: loss(labels, out))
    generator = torch.Generator().manual_seed(0)
    for i in range(30):
        rows = slice(4 * (i % 4), 4 * (i % 4) + 4)
        step(state, x[rows], y[rows], generator)
    stats = compute_precise_batch_stats(module, None, [x[:8], x[8:]], deterministic=True)
    tts.load_batch_stats(module, stats)
    return module.eval()


def test_trained_model_meets_the_reference_bf16_budget():
    module = _trained_tiny_unet()
    x = torch.from_numpy(_images(6, H, W, C, seed=17) / 255.0).float()
    outs = {}
    for dtype in ("float32", "bfloat16"):
        fn = build_s2d_apply(module, output="labels_s2d", dtype=dtype)
        with torch.no_grad():
            lab_s2d = fn(x)
        maps = tb.boundary_maps_from_s2d_labels(lab_s2d, C, transposed="s2d")
        rows = tmp.delineate_s2d(maps, backend="reference")
        outs[dtype] = (d2s(lab_s2d)[..., 0].numpy(), rows.numpy().astype(np.float64))
    lab32, rows32 = outs["float32"]
    lab16, rows16 = outs["bfloat16"]
    agree = (lab32 == lab16).mean()
    mae = np.abs(rows32 - rows16).mean()
    assert agree > BUDGET_AGREEMENT, agree
    assert mae < BUDGET_MAE, mae


@pytest.fixture(scope="module")
def deeplab():
    container = jax_model_class("deeplabv3plus")(
        input_channels=3, num_classes=C, image_height=DH, image_width=DW
    )
    jmod = container.build_model()
    variables = _np_tree(
        jax.jit(lambda k: jmod.init(k, jnp.zeros((1, DH, DW, 3)), training=False))(
            jax.random.PRNGKey(99)
        )
    )
    return jmod, _random_stats(variables, 5), container.get_config()


def test_folded_deeplab_bf16_forward_matches_jax(deeplab):
    jmod, variables, config = deeplab
    pre = get_model_class("deeplabv3plus")(**config).get_preprocess_input_fn()
    x = pre(_images(2, DH, DW, C, seed=21, channels=3))
    outs = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        apply_fn, folded = maybe_build_folded_apply(jmod, variables, dtype=dtype)
        outs[dtype] = np.asarray(jax.jit(apply_fn)(folded, x))
    port = get_model_class("deeplabv3plus")(**config).build_model(device="cpu")
    port.load_state_dict(model_io.state_dict_from_flax(variables))
    forward, kind = select_optimized_forward(port, compute_dtype="bfloat16")
    assert kind == "folded" and not forward.use_bn
    assert forward.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in forward.parameters())
    with torch.no_grad():
        got = forward(torch.from_numpy(x)).numpy()
    want, want32 = outs[jnp.bfloat16], outs[jnp.float32]
    gap, jax_gap = np.abs(got - want).max(), np.abs(want - want32).max()

    assert got.dtype == np.float32
    assert gap <= DEEPLAB_PROB_ATOL and gap < jax_gap, (gap, jax_gap)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= MIN_AGREEMENT


@pytest.fixture(scope="module")
def bf16_checkpoint(tmp_path_factory):
    """A JAX checkpoint of the goldens' U-Net whose config says
    ``dtype="bfloat16"``, with seeded running statistics."""
    module, variables, config = _golden_unet()
    config = {**config, "dtype": "bfloat16"}
    path = tmp_path_factory.mktemp("torch_bf16") / "bf16.hdf5"
    jax_save_model(path, "unet", config, _random_stats(variables, 6))
    return path


def test_bf16_export_serves_bit_equal_to_eager(bf16_checkpoint, tmp_path, capsys):
    out = tmp_path / "bf16.pt2"
    assert cli.main([
        "export", str(bf16_checkpoint), str(out), "--compute-dtype", "bfloat16",
        "--batch-size", "2", "--platforms", "cpu", "--device", "cpu",
    ]) in (0, None)
    art = load_exported_pipeline(out, device="cpu")
    assert art.metadata["compute_dtype"] == "bfloat16"
    assert art.metadata["optimized_forward"] == "s2d"
    images = _images(2, H, W, C, seed=41)
    loaded, config = model_io.load_model_and_config(bf16_checkpoint, device="cpu")
    assert config["dtype"] == "bfloat16" and loaded.module.compute_dtype == torch.bfloat16
    labels_fn, _ = select_optimized_forward(loaded.module, compute_dtype="bfloat16")
    eager = make_fused_pipeline(
        None, get_model_class("unet")(**config).get_preprocess_input_fn(),
        minpath_tie_parity="fast", labels_apply_fn=labels_fn, num_classes=C, device="cpu",
    )(images)
    for got, want in zip(art(images), eager):
        assert torch.equal(got, want)
