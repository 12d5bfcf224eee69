"""The port's TransUNet (``models/transunet.py``) against the plain reference
(``tests/plain_transunet.py``) on the CPU, at a tiny size: hidden 32, 2
layers of 4 heads, MLP 64, ResNet units [1, 1, 1] at width 32 (GroupNorm's
32 groups), decoder [16, 8, 8, 4], 64x96 images (a 4x6 token grid).

The weights are drawn from a seed with the benchmark's kinds and the
decoder's BatchNorm statistics calibrated on a batch, as the benchmark's
cell does; both sides load the same tensors.

Tolerance: logits atol 1e-4. Both sides compute in float32 in other
orders (weight standardisation each forward or once, GroupNorm and
LayerNorm by formula or by PyTorch's kernels, attention written out or
through ``scaled_dot_product_attention``, BatchNorm or folded into the
conv), about 40 layers deep over logits of magnitude up to about 7. The
decoder's BatchNorms divide by ``sqrt(var + 1e-5)`` with batch statistics
in which a channel mostly zeroed by its ReLU has a variance near 0, which
scales a float32 rounding by up to 1 / sqrt(1e-5), about 300 (measured:
2.8e-5 at most, in each variant). Labels are compared where the
reference's margin between its two best logits exceeds twice the
tolerance, and rows for the B-scans whose labels equal the reference's.
"""

import numpy as np
import pytest
import torch

from oct_image_segmentation_models_torch.common import model_io, profiling
from oct_image_segmentation_models_torch.common.model_io import LoadedModel
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.models import transunet as port_transunet
from oct_image_segmentation_models_torch.models.unet import BatchNorm
from oct_image_segmentation_models_torch.ops import losses, metrics
from oct_image_segmentation_models_torch.ops.inference import make_fused_pipeline, select_optimized_forward
from oct_image_segmentation_models_torch.parallel import train_step as tts
from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

import plain_transunet as ref

H, W, C = 64, 96, 4
CONFIG = dict(
    input_channels=3, num_classes=C, image_height=H, image_width=W, hidden=32, layers=2, heads=4,
    mlp=64, resnet_units=[1, 1, 1], resnet_width=32, decoder_channels=[16, 8, 8, 4], n_skip=3,
)
LOGIT_ATOL = 1e-4


def _weights(seed: int) -> dict:
    """The benchmark's draws (``portbench/harness/data.py::make_weights``):
    kernels He-normal on the fan-in, biases and the position embedding
    N(0, 0.05^2), norm scales 1 + N(0, 0.1^2), shifts N(0, 0.05^2)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, kind in ref.param_spec(CONFIG):
        z = torch.randn(shape, generator=gen)
        if kind == "conv_w":
            z = z * (2.0 / (z.numel() // shape[0])) ** 0.5
        elif kind in ("conv_b", "bn_b"):
            z = 0.05 * z
        elif kind == "bn_w":
            z = 1.0 + 0.1 * z
        elif kind == "bn_mean":
            z = 0.1 * z
        else:
            z = torch.exp(0.2 * z)
        out[name] = z
    return out


def _images(n: int, seed: int) -> np.ndarray:
    """Layered grey B-scans with noise, over 3 channels."""
    r = np.random.default_rng(seed)
    rows = np.arange(H)[:, None]
    bounds = np.sort(r.integers(8, H - 8, (n, C - 1, 1)) + np.cumsum(r.integers(-1, 2, (n, C - 1, W)), -1), 1)
    labels = (rows[None, None] >= bounds[:, :, None, :]).sum(1)
    grey = np.linspace(40, 220, C)[labels] + r.normal(0, 8.0, labels.shape)
    return np.repeat(np.clip(grey, 0, 255).astype(np.uint8)[..., None], 3, axis=-1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    """Seeded weights, the decoder BatchNorms' statistics set to a batch's."""
    w = _weights(7)
    stats = {}
    with torch.no_grad():
        ref.logits(w, ref.preprocess(torch.from_numpy(_images(4, 1))), CONFIG, train=True, stats=stats)
    for prefix, (mean, var) in stats.items():
        w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"] = mean, var
    return w


def _module(weights):
    module = get_model_class("transunet")(**CONFIG).build_model(device="cpu")
    module.load_state_dict(weights)
    return module


def _head_logits(module, x):
    """The module's probabilities and its head's output (the logits)."""
    seen = []
    hook = module.head.register_forward_hook(lambda m, i, o: seen.append(o))
    try:
        probs = module(x)
    finally:
        hook.remove()
    return probs, seen[0]


@pytest.mark.parametrize("variant", ["eval", "folded", "train"])
def test_forward_matches_the_plain_reference(weights, variant):
    module = _module(weights)
    assert list(module.state_dict()) == [name for name, _s, _k in ref.param_spec(CONFIG)]
    images = torch.from_numpy(_images(3, 2))
    pre = get_model_class("transunet")(**CONFIG).get_preprocess_input_fn()
    train = variant == "train"
    if variant == "folded":
        module = port_transunet.fold_transunet(module)
        assert not module.use_bn and not any(isinstance(m, BatchNorm) for m in module.modules())
    with torch.set_grad_enabled(train):
        probs, got = _head_logits(module.train(train), pre(images.to(torch.float32)))
        want = ref.logits(weights, ref.preprocess(images), CONFIG, train=train)
    torch.testing.assert_close(got, want, atol=LOGIT_ATOL, rtol=0)
    torch.testing.assert_close(probs, torch.softmax(want, 1).permute(0, 2, 3, 1), atol=LOGIT_ATOL, rtol=0)
    assert float(want.abs().max()) > 1.0  # logits of a scale the tolerance means something at


class _Reference(torch.nn.Module):
    """The plain reference as a probability forward for the fused chain."""

    def __init__(self, weights):
        super().__init__()
        self.weights = weights

    def forward(self, x):
        return torch.softmax(ref.logits(self.weights, x, CONFIG), 1).permute(0, 2, 3, 1)


def test_volume_segmenter_serves_it_folded(weights):
    loaded = LoadedModel("transunet", _module(weights), dict(CONFIG))
    seg = VolumeSegmenter(loaded, dict(CONFIG), batch_size=4, device="cpu")
    assert seg.kind == "folded"
    volume = _images(6, 3)  # a whole batch and a padded one
    labels, rows = seg.segment_volume(volume)
    assert labels.shape == (6, H, W) and rows.shape == (6, C - 1, W) and rows.dtype == np.uint16
    pre = get_model_class("transunet")(**CONFIG).get_preprocess_input_fn()
    pipe = make_fused_pipeline(_Reference(weights), pre, minpath_tie_parity="fast", device="cpu")
    want_labels, _maps, want_rows = (t.numpy() for t in pipe(torch.from_numpy(volume)))
    with torch.no_grad():
        top2 = ref.logits(weights, ref.preprocess(torch.from_numpy(volume)), CONFIG).topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]).numpy() > 2 * LOGIT_ATOL
    assert np.array_equal(labels[clear], want_labels[clear])
    # Rows follow from the labels by the same chain: equal wherever a
    # B-scan's labels are (every B-scan whose labels are all decided, and
    # here more).
    same = (labels == want_labels).all(axis=(1, 2))
    assert (same >= clear.all(axis=(1, 2))).all() and same.sum() >= 3, same
    assert np.array_equal(rows[same], want_rows[same])
    with pytest.raises(ValueError, match="multiples of 16"):
        seg.segment_volume(volume[:, :56])


def test_spans_under_a_profiler(weights):
    module = _module(weights)
    profiling.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
            module(torch.rand(2, H, W, 3))
        totals = profiling.span_totals()
    finally:
        profiling.reset_spans()
    assert {"transunet.hybrid", "transunet.encoder", "transunet.decoder"} <= set(totals)
    assert totals["transunet.encoder"]["counts"] == {"tokens": 2 * (H // 16) * (W // 16), "layers": 2}


@pytest.mark.parametrize("folded", [False, True])
def test_registry_and_checkpoint_round_trip(weights, tmp_path, folded):
    container = get_model_class("transunet")(**CONFIG)
    assert container.spatial_divisor == 16 and container.get_config() == CONFIG
    module = _module(weights)
    if folded:
        module = port_transunet.fold_transunet(module)
    path = tmp_path / "transunet.hdf5"
    model_io.save_model(path, "transunet", container.get_config(), module.state_dict())
    loaded = model_io.load_model(path, device="cpu")
    assert loaded.name == "transunet" and loaded.model_config == CONFIG
    assert loaded.module.use_bn is not folded
    got, want = loaded.module.state_dict(), module.state_dict()
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_one_train_step_against_the_reference(weights):
    """One SGD step: the loss and every parameter's change (-lr * grad) as
    the reference's autograd gives them."""
    lr = 0.1
    module = _module(weights)
    loss_fn = losses.focal_dice_loss(num_classes=C, is_y_true_sparse=True)
    metric_fn = metrics.dice_coef_macro(True, C)
    state = tts.create_train_state(module, tts.build_optimizer("sgd", {"learning_rate": lr}))
    step = tts.make_train_step(module, loss_fn, metric_fn)
    images = torch.from_numpy(_images(2, 5)).to(torch.float32) / 255.0
    labels = torch.from_numpy(np.random.default_rng(5).integers(0, C, (2, H, W, 1)))
    state, loss, _metric = step(state, images, labels, None)
    params = {k: v.clone().requires_grad_(v.dtype.is_floating_point) for k, v in weights.items()}
    want = loss_fn(labels, torch.softmax(ref.logits(params, images, CONFIG, train=True), 1).permute(0, 2, 3, 1))
    want.backward()
    assert abs(float(loss) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    for name, p in module.named_parameters():
        change = p.detach() - weights[name]
        torch.testing.assert_close(change, -lr * params[name].grad, atol=2e-6, rtol=1e-3)
        # A key's bias adds q.b to every score of a query, which the softmax
        # over the keys cancels: its gradient is 0 but for rounding.
        assert name.endswith("attn.key.bias") or change.abs().max() > 0, name
    assert state.step == 1
    assert not torch.equal(module.decoder.conv_more.bn.running_mean, weights["decoder.conv_more.bn.running_mean"])


def test_bfloat16_raises_and_parity_without_optimize(weights):
    module = _module(weights)
    with pytest.raises(ValueError, match="compute_dtype='bfloat16'"):
        select_optimized_forward(module, compute_dtype="bfloat16")
    forward, kind = select_optimized_forward(module, optimize=False)
    assert kind == "parity" and forward is module
