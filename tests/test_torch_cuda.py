"""Tests of the port that need an NVIDIA GPU: they skip elsewhere.

They import neither JAX nor ``tests/conftest.py``'s setup, so on a
machine with a card and no JAX they run as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import copy
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from oct_image_segmentation_models_torch.ops.boundary import image_maps_to_s2d
from oct_image_segmentation_models_torch.ops.minpath import (
    delineate_reference,
    delineate_s2d_reference,
)
from oct_image_segmentation_models_torch.ops.minpath_cuda import (
    choice_store,
    delineate_cuda,
    delineate_cuda_s2d,
)
from oct_image_segmentation_models_torch.ops.s2d_enc_pair import (
    fused_enc_pair,
    fused_enc_pair_reference,
)
from oct_image_segmentation_models_torch.ops.s2d_enc_pair_cuda import (
    enc_pair_tile,
    fused_enc_pair_cuda,
)
from oct_image_segmentation_models_torch.ops.s2d_unet import phase_max_pool

# The encoder-pair kernel sums in another order than cuDNN: float32 sums of
# depth up to 4 * 4C = 1024 at O(1) activations (the JAX kernel test's 1e-4).
PAIR_ATOL = 1e-4

# The min-path map families of tests/test_minpath.py, shared with
# tests/test_torch_minpath.py (this module imports no JAX, so the card's
# machine can import it).
FAMILIES = ("ridge", "jumps", "gaps", "plateau", "flat_tail", "sparse", "dense")


def _smooth_rows(rng, w, h, max_step=1, margin=2):
    rows = [rng.integers(margin, h - margin)]
    for _ in range(w - 1):
        step = rng.integers(-max_step, max_step + 1)
        rows.append(int(np.clip(rows[-1] + step, margin, h - margin)))
    return np.array(rows)


def _ridge_map(w, h, rows):
    m = np.zeros((w, h), dtype=np.uint8)
    m[np.arange(w), rows] = 255
    return m


def _family_map(rng, family, w, h):
    """The map families of tests/test_minpath.py, one (W, H) map."""
    if family == "sparse":
        return (rng.random((w, h)) < 0.15).astype(np.uint8) * 255
    if family == "dense":
        return rng.integers(0, 256, size=(w, h), dtype=np.uint8)
    if family == "jumps":
        return _ridge_map(w, h, _smooth_rows(rng, w, h, max_step=4))
    m = _ridge_map(w, h, _smooth_rows(rng, w, h, max_step=2))
    if family == "gaps":
        m[rng.choice(w, size=6, replace=False), :] = 0
    elif family == "plateau":
        m |= np.roll(m, 1, axis=1)
        if rng.random() < 0.5:
            m |= np.roll(m, 2, axis=1)
    elif family == "flat_tail":
        tail = int(rng.integers(3, 9))
        if rng.random() < 0.5:
            m[-tail:, :] = 0
        else:
            m[:tail, :] = 0
    return m


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


def _both_kernels(maps_t, g, tie_parity):
    """B1 on (N, W, H) maps and B2 on the same maps in s2d layout (W, H
    even), each held bit for bit against its plain version; returns the
    choice store the launches took."""
    n, w, h = maps_t.shape
    got = delineate_cuda(maps_t, max_grad=g, tie_parity=tie_parity)
    want = delineate_reference(maps_t, max_grad=g, tie_parity=tie_parity)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if w % 2 == 0 and h % 2 == 0:
        s2d = image_maps_to_s2d(maps_t.transpose(-1, -2).reshape(1, n, h, w))
        got_s2d = delineate_cuda_s2d(s2d, max_grad=g, tie_parity=tie_parity)
        torch.cuda.synchronize()
        assert torch.equal(got_s2d[0], want)
        assert torch.equal(
            got_s2d, delineate_s2d_reference(s2d, max_grad=g, tie_parity=tie_parity)
        )
    return choice_store(w, h, g)


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
@pytest.mark.parametrize("max_grad", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_kernels_match_reference_on_families(cuda, family, max_grad, tie_parity):
    rng = np.random.default_rng(FAMILIES.index(family) * 10 + max_grad)
    maps = np.stack([_family_map(rng, family, 24, 20) for _ in range(6)])
    store = _both_kernels(torch.from_numpy(maps).to(cuda), max_grad, tie_parity)
    assert store == "shared"


def _constant_maps(n, w, h):
    """Tie-heavy maps: all 0, all 255, all 128, and 255 plateaus of 1-8
    rows wandering across the columns."""
    rng = np.random.default_rng(w + h)
    maps = [np.full((w, h), v, np.uint8) for v in (0, 255, 128)]
    for _ in range(max(0, n - 3)):
        m = np.zeros((w, h), np.uint8)
        rows = np.clip(h // 2 + np.cumsum(rng.integers(-1, 2, w)), 0, h - 9)
        width = rng.integers(1, 9)
        for j, r in enumerate(rows):
            m[j, r : r + width] = 255
        maps.append(m)
    return np.stack(maps[:n])


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
@pytest.mark.parametrize(
    "kind,n,w,h,g,store",
    [
        ("constant", 5, 64, 32, 1, "shared"),
        ("constant", 5, 40, 500, 2, "shared"),  # H not a power of two
        ("families", 5, 64, 1024, 1, "shared"),  # H = 1024, odd N
        ("families", 3, 640, 1024, 1, "scratch"),  # planes past shared memory
        ("constant", 3, 600, 1024, 2, "scratch"),
        ("families", 7, 33, 45, 1, "shared"),  # odd W and H: B1 only
        ("families", 7, 48, 40, 4, "shared"),  # max_grad 4: run-time max_grad
        ("constant", 3, 40, 40, 30, "shared"),  # max_grad 30, the largest
    ],
)
def test_kernels_match_reference_on_variants(cuda, kind, n, w, h, g, store, tie_parity):
    if kind == "constant":
        maps = _constant_maps(n, w, h)
    else:
        rng = np.random.default_rng(n * w + h)
        maps = np.stack(
            [_family_map(rng, FAMILIES[i % len(FAMILIES)], w, h) for i in range(n)]
        )
    before = dict(delineate_cuda.store_launches)
    assert _both_kernels(torch.from_numpy(maps).to(cuda), g, tie_parity) == store
    assert delineate_cuda.store_launches[store] == before[store] + 1


def _pair_args(rng, cuda, b, nh, nw, cin4, c4):
    def t(*shape, fan_in):
        a = (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)
        return torch.from_numpy(a).to(cuda)

    return (
        t(b, nh, nw, cin4, fan_in=1),
        t(2, 2, cin4, c4, fan_in=4 * cin4),
        t(c4, fan_in=1),
        t(2, 2, c4, c4, fan_in=4 * c4),
        t(c4, fan_in=1),
    )


@pytest.mark.parametrize(
    "b,nh,nw,cin4,c4,tile",
    [
        (8, 128, 256, 128, 256, "8x16"),  # the flagship level 1
        (2, 13, 37, 128, 256, "8x16"),  # ragged: nh, nw not multiples of the tile
        (2, 10, 20, 256, 512, "4x8"),  # 4C = 512
        (1, 7, 9, 12, 40, "8x16"),  # 4Cin not a multiple of 8, C not of 8
    ],
)
def test_enc_pair_kernel_variants(cuda, b, nh, nw, cin4, c4, tile):
    args = _pair_args(np.random.default_rng(nh + c4), cuda, b, nh, nw, cin4, c4)
    assert enc_pair_tile(c4) == tile
    before = fused_enc_pair_cuda.tile_launches[tile]
    y2, pooled = fused_enc_pair_cuda(*args)
    torch.cuda.synchronize()
    assert fused_enc_pair_cuda.tile_launches[tile] == before + 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want_y2, want_pool = fused_enc_pair_reference(*args)
    assert torch.isfinite(y2).all()
    assert float((y2 - want_y2).abs().max()) <= PAIR_ATOL
    assert float((pooled - want_pool).abs().max()) <= PAIR_ATOL
    assert torch.equal(pooled, phase_max_pool(y2))


MIN_AGREEMENT = 0.999  # card and CPU float32 forwards sum in other orders


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
def test_staged_pipeline_on_the_card_matches_the_cpu(cuda, tie_parity):
    """The staged path on the card goes through B1; its rows and masks are
    bit-equal to the CPU graph stage on the card's maps, and its labels
    agree with the CPU pipeline's."""
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops.inference import StagedPipeline

    from synth import make_layered_sample

    h, w, c = 128, 192, 4
    container = get_model_class("unet")(
        input_channels=1, num_classes=c, image_height=h, image_width=w,
        start_neurons=8, pool_layers=3,
    )
    module = container.build_model(generator=torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(8)
    images = np.stack([make_layered_sample(rng, h, w, c)[0] for _ in range(3)])[..., None]
    cpu = StagedPipeline(
        module, container.get_preprocess_input_fn(), minpath_tie_parity=tie_parity,
        device="cpu",
    )
    labels_cpu, _, _ = cpu.convert(cpu.predict_probs(images))
    card = StagedPipeline(
        module, container.get_preprocess_input_fn(), minpath_tie_parity=tie_parity,
        device=cuda,
    )
    assert card.kind == "s2d"
    labels, categorical, maps = card.convert(card.predict_probs(images))
    before = delineate_cuda.launches
    rows, masks = card.graph_search(maps)
    torch.cuda.synchronize()
    assert delineate_cuda.launches == before + 1
    assert float((labels.cpu() == labels_cpu).float().mean()) >= MIN_AGREEMENT
    want_rows, want_masks = cpu.graph_search(maps.cpu())
    assert torch.equal(rows.cpu(), want_rows)
    assert torch.equal(masks.cpu(), want_masks)
    assert categorical.dtype == torch.float32 and rows.dtype == torch.uint16


# The card's float32 forward against the CPU's: sums in another order over
# the ResNet50's ~50 convs (chip_smoke.py's PROB_ATOL; measured 4.8e-6 at
# 2 x 128x256).
DEEPLAB_PROB_ATOL = 1e-4


def _deeplab(h, w, seed=5):
    from oct_image_segmentation_models_torch.models import get_model_class

    from synth import make_layered_sample

    container = get_model_class("deeplabv3plus")(
        input_channels=3, num_classes=4, image_height=h, image_width=w
    )
    module = container.build_model(generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    gray = np.stack([make_layered_sample(rng, h, w, 4)[0] for _ in range(2)])
    return container, module, np.repeat(gray[..., None], 3, axis=-1)


@pytest.mark.parametrize("folded", [False, True])
def test_deeplab_forward_on_the_card_matches_the_cpu(cuda, folded):
    from oct_image_segmentation_models_torch._device import float32_precision
    from oct_image_segmentation_models_torch.models.deeplabv3plus import fold_batchnorm

    container, module, images = _deeplab(64, 128)
    if folded:
        module = fold_batchnorm(module)
    x = torch.from_numpy(container.get_preprocess_input_fn()(images))
    with torch.inference_mode(), float32_precision():
        want = module(x)
        got = copy.deepcopy(module).to(cuda)(x.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= DEEPLAB_PROB_ATOL
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= MIN_AGREEMENT


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
def test_deeplab_fused_pipeline_on_the_card_goes_through_b1(cuda, tie_parity):
    """The folded DeepLab pipeline on the card: one B1 launch per call, rows
    bit-equal to the CPU min-path on the card's maps, labels as the CPU
    pipeline's."""
    from oct_image_segmentation_models_torch.ops.inference import (
        make_fused_pipeline,
        select_optimized_forward,
    )
    from oct_image_segmentation_models_torch.ops.minpath import delineate_image_maps

    container, module, images = _deeplab(64, 128)
    forward, kind = select_optimized_forward(module)
    assert kind == "folded"
    # make_fused_pipeline moves the module it is given: one copy per device
    pipes = {
        dev: make_fused_pipeline(
            copy.deepcopy(forward), container.get_preprocess_input_fn(),
            minpath_tie_parity=tie_parity, device=dev,
        )
        for dev in ("cpu", cuda)
    }
    labels_cpu, _, _ = pipes["cpu"](torch.from_numpy(images))
    before = delineate_cuda.launches
    labels, maps, rows = pipes[cuda](torch.from_numpy(images))
    torch.cuda.synchronize()
    assert delineate_cuda.launches == before + 1
    assert float((labels.cpu() == labels_cpu).float().mean()) >= MIN_AGREEMENT
    want = delineate_image_maps(maps.cpu(), tie_parity=tie_parity)
    assert torch.equal(rows.cpu(), want.to(torch.uint16))


def test_segment_maps_on_the_card_goes_through_b1(cuda):
    from oct_image_segmentation_models_torch.min_path_processing import graph_search
    from oct_image_segmentation_models_torch.ops.minpath import delineate_float

    rng = np.random.default_rng(12)
    maps = np.stack([_family_map(rng, f, 96, 64) for f in FAMILIES])
    gs = graph_search.create_graph_structure((96, 64))
    before = delineate_cuda.launches
    rows, _, _ = graph_search.segment_maps(maps, None, gs, device=cuda)
    assert delineate_cuda.launches == before + 1
    want = delineate_reference(torch.from_numpy(maps)).numpy()
    np.testing.assert_array_equal(rows, want.astype(np.uint16))
    # The float DP is plain PyTorch: exact IEEE steps, the same rows.
    fmaps = torch.from_numpy(rng.random((4, 96, 64)).astype(np.float32))
    assert torch.equal(delineate_float(fmaps.to(cuda)).cpu(), delineate_float(fmaps))


def test_train_step_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """One precise-BN refresh and one train step (focal + Dice, Adam) on
    the card and on the CPU from the same weights, batch and dropout mask,
    under the global TF32 defaults (the entry points set float32
    themselves): loss rel 1e-4, BN statistics atol 1e-5. The card's
    gradients are held against the CPU float64 step that takes the card
    step's ReLU gates and max-pool picks (``chip_smoke.GateRecorder``),
    per tensor within 1e-4 of its max + 1e-7: a gate that flips between
    float32 and float64 moves a pixel's gradient by far more than
    rounding. The biases of convs that feed a batch-statistics BatchNorm
    have an exact gradient of 0: below 1e-4 of the largest gradient."""
    import copy

    from chip_smoke import GateRecorder, unet_functional
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.models import unet as unet_module
    from oct_image_segmentation_models_torch.ops import losses, metrics
    from oct_image_segmentation_models_torch.ops.bn_refresh import BNRefresher
    from oct_image_segmentation_models_torch.parallel import train_step as ts

    from synth import make_layered_sample

    h, w, c = 64, 96, 4
    container = get_model_class("unet")(
        input_channels=1, num_classes=c, image_height=h, image_width=w,
        start_neurons=8, pool_layers=3,
    )
    card = container.build_model(generator=torch.Generator().manual_seed(4), device=cuda)
    initial = copy.deepcopy(card).cpu()
    rng = np.random.default_rng(9)
    samples = [make_layered_sample(rng, h, w, c) for _ in range(2)]
    x = torch.from_numpy(np.stack([s[0] for s in samples])[..., None] / 255.0).float()
    y = torch.from_numpy(np.stack([s[1] for s in samples])[..., None])
    mask = {}

    def shared_mask(t, generator):
        if "m" not in mask:
            mask["m"] = torch.rand(t.shape, generator=torch.Generator().manual_seed(1)) < 0.5
        return mask["m"].to(t.device)

    monkeypatch.setattr(unet_module, "dropout_mask", shared_mask)
    loss_fn = losses.focal_dice_loss(num_classes=c)
    metric_fn = metrics.dice_coef_macro(True, c)
    recorded = GateRecorder()
    out = {}
    for name, module, recorder in (
        ("card", card, recorded),
        ("cpu", copy.deepcopy(initial), GateRecorder()),
        ("cpu64", copy.deepcopy(initial).double(), GateRecorder(replay=recorded)),
    ):
        dev = next(module.parameters()).device
        # before the step: Adam moves the pre-BN conv biases by float
        # noise, which the refreshed means would see
        precise = BNRefresher(module, deterministic=True)(None, [x.to(dev)])
        state = ts.create_train_state(module, ts.build_optimizer("adam", {}))
        step = ts.make_train_step(module, loss_fn, metric_fn)
        with unet_functional(recorder):
            _, loss, _ = step(state, x.to(dev), y.to(dev), None)
        grads = {k: p.grad.cpu().double() for k, p in module.named_parameters()}
        stats = {k: v.cpu().float() for k, v in ts.batch_stats(module).items()}
        out[name] = (float(loss), grads, stats, {k: v.cpu().float() for k, v in precise.items()})
    (l_card, g_card, s_card, p_card), (l_cpu, g_cpu, s_cpu, p_cpu) = out["card"], out["cpu"]
    g64 = out["cpu64"][1]
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    gmax = max(float(g.abs().max()) for g in g64.values())
    for k, g in g64.items():
        if k.startswith("blocks.") and k.endswith("conv.bias"):
            assert float(g_card[k].abs().max()) <= 1e-4 * gmax, k
            assert float(g_cpu[k].abs().max()) <= 1e-4 * gmax, k
        else:
            err = float((g_card[k] - g).abs().max())
            assert err <= 1e-4 * float(g.abs().max()) + 1e-7, (k, err)
    for k in s_cpu:
        assert float((s_card[k] - s_cpu[k]).abs().max()) <= 1e-5, k
    for k in p_cpu:
        assert float((p_card[k] - p_cpu[k]).abs().max()) <= 1e-5 * max(1.0, float(p_cpu[k].abs().max())), k


def test_train_step_never_waits_for_the_host(cuda):
    """A warm train step with class weights and device augmentation makes
    no synchronising CUDA call (``set_sync_debug_mode("error")`` raises on
    one): the loss, metric and optimizer stay on the card."""
    from oct_image_segmentation_models_torch.common.augmentation import add_noise_aug, flip_aug
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops import losses, metrics
    from oct_image_segmentation_models_torch.ops.augment import build_device_augmenter
    from oct_image_segmentation_models_torch.parallel import train_step as ts

    c = 3
    module = get_model_class("unet")(
        input_channels=1, num_classes=c, image_height=32, image_width=64,
        start_neurons=4, pool_layers=2,
    ).build_model(generator=torch.Generator().manual_seed(0), device=cuda)
    augment = build_device_augmenter(
        [(flip_aug, {"flip_type": "left-right"}), (add_noise_aug, {"mode": "gaussian"})]
    )
    step = ts.make_train_step(
        module,
        losses.focal_dice_loss(num_classes=c, class_weight=np.array([1.0, 2.0, 0.5])),
        metrics.dice_coef_macro(True, c),
        input_transform=augment,
    )
    state = ts.create_train_state(module, ts.build_optimizer("adam", {}))
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((3, 32, 64, 1), device=cuda)
    y = torch.randint(0, c, (3, 32, 64, 1), device=cuda)
    choices = torch.tensor([-1, 0, 1], dtype=torch.int32, device=cuda)
    step(state, x, y, gen, choices)  # first use: optimizer state, class weights
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, loss, metric = step(state, x, y, gen, choices)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert loss.is_cuda and metric.is_cuda and np.isfinite(float(loss))


def test_s2d_train_step_never_waits_for_the_host(cuda):
    """A warm train step of the s2d training forward makes no
    synchronising CUDA call either: its index maps are copied to the card
    once, at the first step."""
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops import losses, metrics
    from oct_image_segmentation_models_torch.ops.s2d_train import S2DTrainForward
    from oct_image_segmentation_models_torch.parallel import train_step as ts

    c = 3
    module = get_model_class("unet")(
        input_channels=1, num_classes=c, image_height=32, image_width=64,
        start_neurons=4, pool_layers=2,
    ).build_model(generator=torch.Generator().manual_seed(0), device=cuda)
    forward = S2DTrainForward(module)
    step = ts.make_train_step(
        forward, losses.focal_dice_loss(num_classes=c), metrics.dice_coef_macro(True, c)
    )
    state = ts.create_train_state(forward, ts.build_optimizer("adam", {}))
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((3, 32, 64, 1), device=cuda)
    y = torch.randint(0, c, (3, 32, 64, 1), device=cuda)
    step(state, x, y, gen)  # first use: optimizer state, index maps
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, loss, metric = step(state, x, y, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert loss.is_cuda and metric.is_cuda and np.isfinite(float(loss))


def test_device_augmenter_on_the_card(cuda):
    """``build_device_augmenter`` on card tensors: a flipped sample equals
    ``torch.flip`` exactly (labels too), an unchosen one is untouched, and
    the Gaussian branch's noise on 0.5-valued pixels has mean 0.01 within
    5 * sqrt(var / n) and variance 0.004 within 3%, labels untouched."""
    from oct_image_segmentation_models_torch.common.augmentation import add_noise_aug, flip_aug
    from oct_image_segmentation_models_torch.ops.augment import build_device_augmenter

    mean, var = 0.01, 0.004
    apply = build_device_augmenter([
        (flip_aug, {"flip_type": "up-down"}),
        (add_noise_aug, {"mode": "gaussian", "mean": mean, "variance": var}),
    ])
    x = torch.rand((3, 256, 256, 1), device=cuda)
    x[2] = 0.5
    y = torch.randint(0, 4, (3, 256, 256, 1), device=cuda, dtype=torch.uint8)
    choices = torch.tensor([-1, 0, 1], dtype=torch.int32, device=cuda)
    ox, oy = apply(torch.Generator(device=cuda).manual_seed(0), x, y, choices)
    assert ox.is_cuda and torch.equal(ox[0], x[0]) and torch.equal(oy[0], y[0])
    assert torch.equal(ox[1], torch.flip(x[1], (0,))) and torch.equal(oy[1], torch.flip(y[1], (0,)))
    assert torch.equal(oy[2], y[2])
    noise = (ox[2] - x[2]).double().cpu().numpy()
    assert abs(noise.mean() - mean) <= 5 * np.sqrt(var / noise.size), noise.mean()
    assert abs(noise.var() - var) <= 0.03 * var, noise.var()


def test_prefetch_copies_to_the_card(cuda):
    """``device_prefetch`` and ``prefetch_to_mesh`` on the card: batches in
    order, equal to the host's (the rank's rows for the mesh), used on the
    consumer's stream after their copy on the side stream."""
    from oct_image_segmentation_models_torch.parallel import input_pipeline as ip
    from oct_image_segmentation_models_torch.parallel.mesh import Mesh

    rng = np.random.default_rng(0)
    batches = [
        (rng.random((4, 256, 512, 1), dtype=np.float32), rng.integers(0, 3, (4, 256, 512, 1)).astype(np.int32))
        for _ in range(5)
    ]
    got = [(x * 2, y + 1) for x, y in ip.device_prefetch(iter(batches), size=2, device=cuda)]
    for (gx, gy), (x, y) in zip(got, batches):
        assert gx.is_cuda and gy.is_cuda
        assert np.array_equal(gx.cpu().numpy(), x * 2) and np.array_equal(gy.cpu().numpy(), y + 1)
    mesh = Mesh(1, 2, 1, cuda)  # local rank 1 of a node of 2, no process group
    got = [(x * 2, y) for x, y in ip.prefetch_to_mesh(iter(batches), mesh)]
    assert len(got) == len(batches)
    for (gx, gy), (x, y) in zip(got, batches):
        assert np.array_equal(gx.cpu().numpy(), x[2:] * 2) and np.array_equal(gy.cpu().numpy(), y[2:])


def test_served_volumes_through_the_staging_ring_match_a_whole_volume_pad(cuda):
    """Volumes of 49, 61, 97 and 128 B-scans at batch 8 through the
    segmenter's staging ring (views of the volume, the last batch padded
    alone, pinned slots kept across volumes, each batch's outputs fetched
    back through the fetch ring) and through a whole-volume pad with each
    batch pinned on its own and the outputs joined on the card and copied
    back at the end: labels and rows identical. After the first volume no
    stage allocates the ring or waits for a slot, and no fetch allocates
    its ring. A warm volume under a profiler with CUDA activity copies
    nothing back to pageable memory."""
    from oct_image_segmentation_models_torch.common import profiling
    from oct_image_segmentation_models_torch.common.model_io import LoadedModel
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter

    from synth import make_layered_sample

    h, w, c, b = 128, 256, 4, 8
    container = get_model_class("unet")(
        input_channels=1, num_classes=c, image_height=h, image_width=w,
        start_neurons=8, pool_layers=4,
    )
    config = container.get_config()
    module = container.build_model(generator=torch.Generator().manual_seed(16), device="cpu")
    seg = VolumeSegmenter(LoadedModel("unet", module, config), config, batch_size=b, device=cuda)
    assert seg.kind == "s2d"
    rng = np.random.default_rng(16)
    pool = np.stack([make_layered_sample(rng, h, w, c)[0] for _ in range(16)])[..., None]
    volumes = [pool[rng.integers(0, len(pool), n)] for n in (49, 61, 97, 128)]

    def whole_volume_pad(volume):
        n = len(volume)
        padded = np.concatenate([volume, volume[-1:].repeat((-n) % b, 0)])
        labels, rows = [], []
        for i in range(0, len(padded), b):
            batch = torch.from_numpy(np.ascontiguousarray(padded[i : i + b])).pin_memory()
            out = seg._pipeline(batch.to(cuda, non_blocking=True))
            labels.append(out[0])
            rows.append(out[2])
        return torch.cat(labels).cpu().numpy()[:n], torch.cat(rows).cpu().numpy()[:n]

    want = [whole_volume_pad(v) for v in volumes]
    profiling.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            got = [seg.segment_volume(v) for v in volumes]
        stages = [r for r in profiling.spans() if r.name == "serve.stage"]
        fetches = [r for r in profiling.spans() if r.name == "serve.fetch"]
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            again = seg.segment_volume(volumes[0])
    finally:
        profiling.reset_spans()
    copies = sorted({e.key for e in prof.key_averages() if e.key.startswith("Memcpy")})
    assert any("DtoH" in k and "Pinned" in k for k in copies), copies
    assert not any("DtoH" in k and "Pageable" in k for k in copies), copies
    np.testing.assert_array_equal(again[0], want[0][0])
    np.testing.assert_array_equal(again[1], want[0][1])
    for (labels, rows), (want_labels, want_rows), v in zip(got, want, volumes):
        assert labels.shape == (len(v), h, w)
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_array_equal(rows, want_rows)
    first = stages[0].request
    assert len(stages) == sum(-(-len(v) // b) for v in volumes)
    assert [r.counts["slot_alloc"] for r in stages if r.request == first] == [1] + [0] * 6
    later = [r.counts for r in stages if r.request != first]
    assert all(k["slot_alloc"] == 0 and k["slot_wait"] == 0 for k in later), later
    assert len(fetches) == len(stages)
    assert [r.counts["slot_alloc"] for r in fetches if r.request == first] == [1] + [0] * 6
    assert all(r.counts["slot_alloc"] == 0 for r in fetches if r.request != first)
    assert all(r.counts["bytes"] == b * (h * w + (c - 1) * w * 2) for r in fetches)


def test_create_mesh_puts_a_bare_cuda_on_the_local_card(cuda, tmp_path):
    """A world of one over NCCL: ``create_mesh(device="cuda")`` (as
    ``TrainingParams(device="cuda")`` under ``torchrun`` passes it) is the
    local rank's card, ``cuda:0``, and the host group is gloo."""
    import torch.distributed as dist
    from datetime import timedelta

    from oct_image_segmentation_models_torch.parallel import mesh as mesh_lib

    mesh_lib.init_distributed(
        "cuda", rank=0, world_size=1, init_method=f"file://{tmp_path / 'store'}",
        timeout=timedelta(seconds=60),
    )
    try:
        mesh = mesh_lib.create_mesh(device="cuda")
        assert mesh.device == torch.device("cuda", 0)
        assert dist.get_backend() == "nccl" and dist.get_backend(mesh.host_group) == "gloo"
        assert mesh_lib.create_mesh(device="cuda").host_group is mesh.host_group
        assert mesh_lib.all_gather_host({"rank": mesh.rank}, mesh) == [{"rank": 0}]
    finally:
        dist.destroy_process_group()


class _OpRecorder(TorchDispatchMode):
    """The names of the operators that run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("tie_parity", ["exact", "fast"])
def test_delineate_reaches_the_registered_operators_on_the_card(cuda, tie_parity):
    """``minpath.delineate[_s2d]`` on the card call
    ``torch.ops.octseg.minpath_delineate[_s2d]``, whose CUDA implementation
    is one launch of B1/B2, bit-equal to the plain version."""
    from oct_image_segmentation_models_torch.ops import minpath

    maps = torch.from_numpy(_maps(np.random.default_rng(5), 3, 64, 96)).to(cuda)
    s2d_maps = image_maps_to_s2d(maps.transpose(-1, -2)[None]).contiguous()
    for fn, op, wrapper, ref, x in (
        (minpath.delineate, "octseg.minpath_delineate.default", delineate_cuda,
         delineate_reference, maps),
        (minpath.delineate_s2d, "octseg.minpath_delineate_s2d.default", delineate_cuda_s2d,
         delineate_s2d_reference, s2d_maps),
    ):
        before = wrapper.launches
        with _OpRecorder() as rec:
            got = fn(x, tie_parity=tie_parity)
        torch.cuda.synchronize()
        assert rec.ops == [op]
        assert wrapper.launches == before + 1
        assert torch.equal(got, ref(x, tie_parity=tie_parity))


def test_exported_pipeline_on_the_card_matches_eager(cuda, tmp_path):
    """An artifact exported for the CPU and the card: on the card it
    launches B2 once per call and gives eager serving's labels, maps and
    rows bit for bit at two batch sizes; its CPU program matches the CPU
    eager pipeline."""
    from oct_image_segmentation_models_torch.common.export import (
        export_inference_pipeline,
        load_exported_pipeline,
    )
    from oct_image_segmentation_models_torch.common.model_io import save_model_dir
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops.inference import (
        make_fused_pipeline,
        select_optimized_forward,
    )

    container = get_model_class("unet")(
        input_channels=1, num_classes=4, image_height=64, image_width=96,
        start_neurons=4, pool_layers=3,
    )
    module = container.build_model(generator=torch.Generator().manual_seed(3), device="cpu")
    save_model_dir(tmp_path / "model.orbax", "unet", container.get_config(), module.state_dict())
    out = export_inference_pipeline(
        tmp_path / "model.orbax", tmp_path / "model.pt2", batch_size=None, device="cpu"
    )
    forward, kind = select_optimized_forward(module)
    assert kind == "s2d"
    rng = np.random.default_rng(0)
    for dev in ("cpu", cuda):
        art = load_exported_pipeline(out, device=dev)
        eager = make_fused_pipeline(
            None, container.get_preprocess_input_fn(), labels_apply_fn=copy.deepcopy(forward),
            num_classes=4, minpath_tie_parity="fast", device=dev,
        )
        for batch in (1, 3):
            images = rng.integers(0, 256, (batch, 64, 96, 1), dtype=np.uint8)
            before = delineate_cuda_s2d.launches
            got = art(images)
            if dev == cuda:
                torch.cuda.synchronize()
                assert delineate_cuda_s2d.launches == before + 1
            for a, b in zip(got, eager(torch.from_numpy(images))):
                assert a.device == b.device and torch.equal(a, b)


def test_bf16_train_step_never_waits_for_the_host(cuda):
    """A warm bfloat16 train step with Adam's bfloat16 first moment makes
    no synchronising CUDA call either."""
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops import losses, metrics
    from oct_image_segmentation_models_torch.parallel import train_step as ts

    c = 3
    module = get_model_class("unet")(
        input_channels=1, num_classes=c, image_height=32, image_width=64,
        start_neurons=4, pool_layers=2, dtype="bfloat16",
    ).build_model(generator=torch.Generator().manual_seed(0), device=cuda)
    step = ts.make_train_step(
        module, losses.focal_dice_loss(num_classes=c), metrics.dice_coef_macro(True, c)
    )
    state = ts.create_train_state(module, ts.build_optimizer("adam", {"mu_dtype": "bfloat16"}))
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((3, 32, 64, 1), device=cuda)
    y = torch.randint(0, c, (3, 32, 64, 1), device=cuda)
    step(state, x, y, gen)  # first use: the optimizer state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, loss, _ = step(state, x, y, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(loss))
    assert all(s["mu"].dtype == torch.bfloat16 for s in state.optimizer.state.values())
    assert all(p.dtype == torch.float32 for p in module.parameters())


@pytest.mark.parametrize("model", ["unet", "deeplabv3plus"])
def test_bf16_forward_on_the_card_matches_the_cpu(cuda, model):
    """The bfloat16 s2d U-Net and folded DeepLabV3+ forwards on the card
    against the CPU's, same weights: probabilities within 5e-2 (each side
    rounds every conv's output to bfloat16 from float32 sums taken in
    another order), argmax equal on >= 99% of the pixels."""
    from oct_image_segmentation_models_torch.models import get_model_class
    from oct_image_segmentation_models_torch.ops.inference import select_optimized_forward

    h, w = 64, 128
    kw = dict(start_neurons=8, pool_layers=3) if model == "unet" else {}
    channels = 1 if model == "unet" else 3
    container = get_model_class(model)(
        input_channels=channels, num_classes=4, image_height=h, image_width=w, **kw
    )
    card = container.build_model(generator=torch.Generator().manual_seed(1), device=cuda)
    output = dict(s2d_output="probs")
    fwd_card, kind = select_optimized_forward(card, compute_dtype="bfloat16", **output)
    fwd_cpu, _ = select_optimized_forward(
        copy.deepcopy(card).cpu(), compute_dtype="bfloat16", **output
    )
    assert kind == ("s2d" if model == "unet" else "folded")
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (2, h, w, channels)).astype(np.float32)
    x = torch.from_numpy(np.asarray(container.get_preprocess_input_fn()(images)))
    from oct_image_segmentation_models_torch._device import precision

    with torch.inference_mode(), precision(torch.bfloat16):
        got = fwd_card(x.to(cuda)).cpu()
        want = fwd_cpu(x)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 5e-2
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= 0.99


def test_deeplab_resize_backward_is_reproducible_on_the_card(cuda):
    """Under deterministic algorithms the DeepLab's bilinear resize on the
    card goes through ``DeterministicResize``: no op warns that it has no
    deterministic kernel, two backward passes are bit-equal, and the
    gradient is the CPU float64 one within 1e-5 of its max (float32 sums
    of a few terms)."""
    from oct_image_segmentation_models_torch.models.deeplabv3plus import resize_bilinear

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, 32, 64))
    g = rng.normal(size=(2, 64, 128, 256))

    def grad(device, dtype):
        xt = torch.tensor(x, dtype=dtype, device=device, requires_grad=True)
        y = resize_bilinear(xt, 128, 256)
        (gx,) = torch.autograd.grad(y, xt, torch.tensor(g, dtype=dtype, device=device))
        return type(y.grad_fn).__name__, gx.cpu()

    prev = (
        torch.are_deterministic_algorithms_enabled(),
        torch.is_deterministic_algorithms_warn_only_enabled(),
    )
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runs = [grad(cuda, torch.float32) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    assert [name for name, _ in runs] == ["DeterministicResizeBackward"] * 2
    assert not [w for w in caught if "does not have a deterministic" in str(w.message)]
    assert torch.equal(runs[0][1], runs[1][1])
    _, want = grad("cpu", torch.float64)
    err = float((runs[0][1].double() - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5, err
