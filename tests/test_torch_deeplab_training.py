"""The port's DeepLabV3+ in training against the JAX package's, on the CPU.

The weights are the port's seeded init carried to Flax
(``flax_from_state_dict``); batches are ``synth.make_layered_sample``
B-scans at 48x64, repeated to 3 channels and preprocessed (the caffe-style
ResNet50 preprocess), 4 classes, batch 2. JAX's step is ``make_train_step``
on a one-device CPU mesh with the plain Flax module, which is what
``train_forward_impl="auto"`` trains for a DeepLabV3+.

The float32 train-mode forward is compared directly (loss and BN
statistics, see ``LOSS_RTOL32``). Its gradients are not: a few dozen
ReLU gates sit within float32 rounding of 0 and take the other side in
float64, and each moves one pixel's gradient in sums that nearly cancel,
so a float32 step's gradients, JAX's and the port's alike, sit tens of
percent of a tensor's max off the float64 step's, in different tensors
(``chip_smoke.py``'s DeepLab step check prints the figures; ROADMAP C).
The gradients, the Adam steps and the precise-BN statistics are therefore held
in float64 on both sides (``jax.enable_x64`` and the Flax module built
with ``dtype=float64``; its head stays float32, as the JAX module fixes
it): gradients per tensor within 1e-5 of the tensor's max (measured
2.8e-7).

The trajectory itself is chaotic at this size: perturbing the initial
weights far below float32 rounding moves the port's own float64 loss by
percents within three Adam steps. So each of the three steps starts from JAX's
parameters and statistics of the step before, with the port's own
optimizer state, and is held to JAX's step (see ``CLEAR_GRAD``).

The conv biases that feed a batch-statistics BatchNorm (the 42 backbone
convs and the DSPP's pooled branch) have an exact gradient of 0; both
frameworks return float noise there, held below 1e-6 of the largest
gradient, and those biases are checked to move by at most lr per step.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oct_image_segmentation_models_tpu.common import model_io as jax_io
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.models.deeplabv3plus import DeeplabV3PlusModule
from oct_image_segmentation_models_tpu.ops import bn_refresh as jax_bn
from oct_image_segmentation_models_tpu.ops import losses as jl
from oct_image_segmentation_models_tpu.ops import metrics as jm
from oct_image_segmentation_models_tpu.parallel import train_step as jts
from oct_image_segmentation_models_tpu.parallel.mesh import create_mesh
from oct_image_segmentation_models_torch.common import model_io as port_io
from oct_image_segmentation_models_torch.models import get_model_class as port_model_class
from oct_image_segmentation_models_torch.ops import bn_refresh as port_bn
from oct_image_segmentation_models_torch.ops import losses as tl
from oct_image_segmentation_models_torch.ops import metrics as tm
from oct_image_segmentation_models_torch.parallel import train_step as tts
from oct_image_segmentation_models_torch.training import TrainingParams, train_model

from synth import make_dataset, make_layered_sample
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

H, W, C, B = 48, 64, 4, 2
CONFIG = dict(input_channels=3, num_classes=C, image_height=H, image_width=W)
RTOL = 1e-5
STAT_ATOL = 1e-5
STAT_RTOL = 1e-6  # the stem's variances reach ~300 (inputs of +-130)
# A trained checkpoint's float32 forward: running variances down to 3e-4
# against the backbone's eps 1.001e-5 magnify rounding; each framework's
# float32 forward sits up to 8.8e-5 off its float64 forward (the two
# float32 forwards 4.6e-5 apart).
TRAINED_ATOL32 = 2e-4
PARAM_ATOL = 1e-5
# float32 on both sides through ~50 batch-statistics BatchNorms of 24
# samples a channel at stride 16: JAX's loss sits 1.5e-5 off the float64
# loss, the port's 1.7e-6; the statistics 8.6e-6 apart.
LOSS_RTOL32 = 5e-5
STAT_ATOL32 = 2e-5
GRAD_REL = 1e-5
ZERO_GRAD_SHARE = 1e-6
LR = 1e-3
MAX_STEPS = 3
# Adam's first step moves a parameter by lr * g / (|g| + 1e-7): where g is
# near 0, rounding noise in g moves it by up to lr. Parameters are held at
# PARAM_ATOL where |g| is above this share of the tensor's largest.
CLEAR_GRAD = 1e-4
# From the second step on, where the moments of the steps before nearly
# cancel, the update normalises the rounding noise of g as well: measured,
# 0.012% of the held entries end more than PARAM_ATOL apart (at most 0.49
# lr), all of them within 2 lr. Every entry is held at 2 lr, and at most
# this share of the held entries may pass PARAM_ATOL.
OUTLIER_SHARE = 1e-3


def _preprocess(images):
    return np.asarray(jax_model_class("deeplabv3plus")(**CONFIG).get_preprocess_input_fn()(images))


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for _ in range(n):
        img, lab, _ = make_layered_sample(rng, H, W, C)
        images.append(img)
        labels.append(lab)
    x = np.repeat(np.stack(images)[..., None], 3, axis=-1).astype(np.float32)
    return _preprocess(x), np.stack(labels)[..., None].astype(np.int32)


STEP_BATCHES = [_batch(10 + i) for i in range(MAX_STEPS)]


@pytest.fixture(scope="module")
def model():
    """(JAX module, variables as numpy). The weights are the port's seeded
    init carried across (``flax_from_state_dict``); nothing here depends on
    JAX's own init draws."""
    container = port_model_class("deeplabv3plus")(**CONFIG)
    init = container.build_model(generator=torch.Generator().manual_seed(3), device="cpu")
    return (
        jax_model_class("deeplabv3plus")(**CONFIG).build_model(),
        port_io.flax_from_state_dict(init.state_dict()),
    )


def _module64():
    """The JAX module computing in float64 (call under ``jax.enable_x64``)."""
    return DeeplabV3PlusModule(num_classes=C, dtype=jnp.float64)


def _port_module(variables):
    module = port_model_class("deeplabv3plus")(**CONFIG).build_model(device="cpu")
    module.load_state_dict(port_io.state_dict_from_flax(variables))
    return module


def _state_dict_of(params, stats):
    return port_io.state_dict_from_flax(
        {
            "params": jax.tree_util.tree_map(np.asarray, params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, stats),
        }
    )


def _pre_bn_bias(key):
    return key.endswith("conv.bias")


def _losses():
    make = dict(num_classes=C, is_y_true_sparse=True)
    return (
        jl.focal_dice_loss(**make),
        tl.focal_dice_loss(**make),
        jm.dice_coef_macro(True, C),
        tm.dice_coef_macro(True, C),
    )


def _check_stats(got: dict, want: dict) -> None:
    for k, v in got.items():
        if "running" in k:
            np.testing.assert_allclose(
                v.double().numpy(), want[k].double().numpy(), atol=STAT_ATOL,
                rtol=STAT_RTOL, err_msg=k,
            )


def test_train_forward_loss_and_stats_float32(model):
    """The float32 train-mode forward: batch statistics, their running
    update and the loss, as JAX's."""
    jmod, variables = model
    x, labels = _batch(1)
    jloss, tloss = _losses()[:2]
    jout, mut = jax.jit(
        lambda v, x: jmod.apply(v, x, training=True, mutable=["batch_stats"])
    )(variables, x)
    module = _port_module(variables).train()
    with torch.no_grad():
        out = module(torch.from_numpy(x), generator=None)
    want = float(jloss(jnp.asarray(labels), jout))
    assert abs(float(tloss(torch.from_numpy(labels), out)) - want) <= LOSS_RTOL32 * abs(want)
    want_stats = _state_dict_of(variables["params"], mut["batch_stats"])
    for k, v in module.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), atol=STAT_ATOL32,
                                       rtol=STAT_RTOL, err_msg=k)


def test_gradients_match_jax_in_float64(model):
    """Loss and every gradient of the first train step, float64 on both
    sides; the pre-BN conv biases bounded as noise. JAX's gradient is read
    from its Adam state after the step (``mu = (1 - b1) * g``)."""
    run, jgrads = _jax_run(model)
    _, want_loss, _ = run[0]
    x, labels = STEP_BATCHES[0]
    module = _port_module(model[1]).double().train()
    loss_value = _losses()[1](torch.from_numpy(labels), module(torch.from_numpy(x).double()))
    loss_value.backward()
    assert abs(float(loss_value) - want_loss) <= RTOL * abs(want_loss)
    gmax = max(float(g.abs().max()) for g in jgrads.values())
    biases = 0
    for name, p in module.named_parameters():
        if _pre_bn_bias(name):
            biases += 1
            assert float(p.grad.abs().max()) <= ZERO_GRAD_SHARE * gmax, name
            assert float(jgrads[name].abs().max()) <= ZERO_GRAD_SHARE * gmax, name
        else:
            err = float((p.grad - jgrads[name]).abs().max())
            assert err <= GRAD_REL * float(jgrads[name].abs().max()), (name, err)
    assert biases == 43


def test_stats_mode_is_train_mode_and_generator_is_unused(model):
    _, variables = model
    x, _ = _batch(2)
    outs, stats = [], []
    for mode in ("stats", "train", "train-gen"):
        module = _port_module(variables)
        with torch.no_grad():
            if mode == "stats":
                outs.append(module(torch.from_numpy(x), stats_mode=True))
            else:
                gen = torch.Generator().manual_seed(1) if mode == "train-gen" else None
                outs.append(module.train()(torch.from_numpy(x), generator=gen))
        stats.append({k: v for k, v in module.state_dict().items() if "running" in k})
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    for k in stats[0]:
        assert torch.equal(stats[0][k], stats[1][k]) and torch.equal(stats[1][k], stats[2][k])


_jax_runs = {}


def _jax_run(model):
    """JAX's float64 Adam trajectory from the bridged weights: after each
    step the state dict, loss and metric; and the first step's gradients
    as a state dict."""
    if "run" in _jax_runs:
        return _jax_runs["run"]
    _, variables = model
    jloss, _, jmetric, _ = _losses()
    with jax.enable_x64(True):
        jmod = _module64()
        mesh = create_mesh(jax.devices()[:1])
        tx = jts.build_optimizer("adam", {})
        variables64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        state = jts.create_train_state(variables64, tx, mesh)
        step = jts.make_train_step(jmod, tx, jloss, jmetric, mesh)
        run = []
        for i, (x, y) in enumerate(STEP_BATCHES):
            state, lv, mv = step(
                state, jnp.asarray(x, jnp.float64), jnp.asarray(y), jax.random.PRNGKey(100 + i)
            )
            run.append((_state_dict_of(state.params, state.batch_stats), float(lv), float(mv)))
            if i == 0:
                (adam,) = [
                    s for s in jax.tree_util.tree_leaves(
                        state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)
                    ) if isinstance(s, optax.ScaleByAdamState)
                ]
                grads = {
                    k: v.double() / (1 - 0.9)
                    for k, v in _state_dict_of(adam.mu, variables["batch_stats"]).items()
                    if "running" not in k
                }
    _jax_runs["run"] = run, grads
    return _jax_runs["run"]


def test_adam_steps_match_jax(model):
    """The port's ``train_step`` against JAX's ``make_train_step``, float64
    on both sides, each
    step from JAX's parameters and statistics of the step before and the
    port's own optimizer state."""
    run = _jax_run(model)[0]
    _, tloss, _, tmetric = _losses()
    module = _port_module(model[1]).double()
    state = tts.create_train_state(module, tts.build_optimizer("adam", {}))
    step = tts.make_train_step(module, tloss, tmetric)
    held, outliers = 0, 0
    for i, ((x, y), (want, wl, wm)) in enumerate(zip(STEP_BATCHES, run)):
        if i:
            module.load_state_dict(run[i - 1][0])
        state, lv, mv = step(state, torch.from_numpy(x).double(), torch.from_numpy(y), None)
        assert abs(float(lv) - wl) <= RTOL * abs(wl) and abs(float(mv) - wm) <= RTOL * abs(wm)
        got = module.state_dict()
        assert set(got) == set(want)
        for k, p in module.named_parameters():
            d = (got[k] - want[k].double()).abs()
            if _pre_bn_bias(k):
                assert float(d.max()) <= LR + 1e-7, (k, float(d.max()))
                continue
            clear = p.grad.abs() > CLEAR_GRAD * p.grad.abs().max()
            held += int(clear.sum())
            outliers += int((clear & (d > PARAM_ATOL)).sum())
            if i == 0:
                assert float(torch.where(clear, d, 0.0).max()) <= PARAM_ATOL, k
            assert float(d.max()) <= 2 * LR, k
        _check_stats(got, want)
    assert state.step == MAX_STEPS
    # the entries held at PARAM_ATOL: all but those of exactly-zero gradient
    assert held >= 0.8 * MAX_STEPS * sum(p.numel() for p in module.parameters()), held
    assert outliers <= OUTLIER_SHARE * held, (outliers, held)


def test_bn_refresher_matches_jax(model):
    """The precise-BN statistics, float64 on both sides (in float32 the
    stage-4 statistics carry the forward's rounding, measured 1.6e-5 at
    a mean of 0.05), and the module left as it was."""
    _, variables = model
    batches = [_batch(30 + i)[0] for i in range(2)]
    with jax.enable_x64(True):
        want = jax_bn.compute_precise_batch_stats(
            _module64(), variables["params"], variables["batch_stats"],
            [jnp.asarray(b, jnp.float64) for b in batches], jax.random.PRNGKey(5),
        )
        want = _state_dict_of(variables["params"], jax.device_get(want))
    module = _port_module(variables).double()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    got = port_bn.BNRefresher(module)(None, [torch.from_numpy(b).double() for b in batches])
    assert set(got) == {k for k in want if "running" in k}
    _check_stats(got, want)
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), f"{k} changed by the refresh"


def test_checkpoints_cross_both_ways(model, tmp_path):
    """A JAX-written DeepLabV3+ checkpoint loads in the port (plain and
    folded) and the port's checkpoint loads in JAX, with equal forwards."""
    jmod, variables = model
    config = jax_model_class("deeplabv3plus")(**CONFIG).get_config()
    x, _ = _batch(60)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, training=False))(variables, x))
    jax_io.save_model(tmp_path / "jax.hdf5", "deeplabv3plus", config, variables)
    loaded = port_io.load_model(tmp_path / "jax.hdf5", device="cpu")
    assert loaded.name == "deeplabv3plus" and loaded.output_classes == C
    with torch.no_grad():
        got = loaded.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

    module = _port_module(variables)
    port_io.save_model(tmp_path / "port.hdf5", "deeplabv3plus", config, module.state_dict())
    back, back_config = jax_io.load_model_and_config(tmp_path / "port.hdf5")
    assert back.name == "deeplabv3plus" and back_config == config
    flat = jax.tree_util.tree_leaves_with_path(back.variables)
    want_flat = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat) == len(want_flat)
    for path, leaf in flat:
        assert np.array_equal(np.asarray(leaf), want_flat[path]), path


def _three_channel_dataset(path):
    """``synth.make_dataset`` with its images repeated to 3 channels, as
    ``tests/test_deeplab_learning.py`` feeds the DeepLabV3+."""
    ds = make_dataset(path, n_train=4, n_val=2, n_test=2, h=H, w=W, num_classes=C, seed=33)
    with h5py.File(ds, "r+") as f:
        for split in ("train", "val", "test"):
            images = f[f"{split}_images"][:]
            del f[f"{split}_images"]
            f[f"{split}_images"] = np.repeat(images, 3, axis=-1)
    return ds


def test_train_model_fresh_initial_and_resumed(model, tmp_path):
    """``train_model`` trains a DeepLabV3+ on the CPU from the seed, from a
    JAX-written ``initial_model`` and from its own train state; JAX's
    ``load_model`` reads the port's ``model_final.hdf5`` and computes the
    port's forward within 1e-5, float64 on both sides (measured 9e-7,
    JAX's float32 head); the port's float32 forward is within
    TRAINED_ATOL32 of its float64 one."""
    _, variables = model
    ds = _three_channel_dataset(tmp_path / "ds.hdf5")
    init = tmp_path / "init.hdf5"
    jax_io.save_model(
        init, "deeplabv3plus", jax_model_class("deeplabv3plus")(**CONFIG).get_config(), variables
    )
    common = dict(
        training_dataset_path=ds, opt_con="adam", opt_params={"learning_rate": LR},
        loss="focal_dice_loss", metric="dice_coef_macro", batch_size=2, seed=0,
        device="cpu",
    )
    fresh = train_model(TrainingParams(
        model_architecture="deeplabv3plus", initial_model=None,
        results_location=tmp_path / "fresh", epochs=1, train_state_checkpoint=True, **common,
    ))
    from_init = train_model(TrainingParams(
        model_architecture=None, initial_model=init, results_location=tmp_path / "init",
        epochs=1, **common,
    ))
    resumed = train_model(TrainingParams(
        model_architecture=None, initial_model=None,
        resume_train_state=fresh / "train_state_latest.npz",
        results_location=tmp_path / "resumed", epochs=2, **common,
    ))
    x, _ = _batch(70)
    with jax.enable_x64(True):
        apply64 = jax.jit(lambda v, x: _module64().apply(v, x, training=False))
    for folder in (fresh, from_init, resumed):
        loaded = port_io.load_model(folder / "model_final.hdf5", device="cpu")
        assert loaded.name == "deeplabv3plus" and loaded.module.use_bn
        back, _ = jax_io.load_model_and_config(folder / "model_final.hdf5")
        with torch.no_grad():
            got32 = loaded.module(torch.from_numpy(x)).numpy()
            got64 = loaded.module.double()(torch.from_numpy(x).double()).numpy()
        with jax.enable_x64(True):
            v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), back.variables)
            want64 = np.asarray(apply64(v64, jnp.asarray(x, jnp.float64)))
        np.testing.assert_allclose(got64, want64, atol=1e-5)
        assert np.isfinite(got32).all() and np.abs(got32 - got64).max() <= TRAINED_ATOL32
    stats = sorted(resumed.glob("stats_epoch*.hdf5"))
    assert stats and stats[-1].name == "stats_epoch02.hdf5"
