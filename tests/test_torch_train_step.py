"""The port's train-mode U-Net, train and eval steps, optimizers and
precise-BN refresher against the JAX package's, on the CPU.

Weights are JAX-initialised and bridged (``state_dict_from_flax``); the
batch is ``synth.make_layered_sample`` at 32x48, 3 classes, batch 2, on the
U-Net at start_neurons=2, pool_layers=2. The port's dropout mask is
replaced by JAX's: ``ops/s2d_train.py::_DropoutShim`` has ``UNetModule``'s
``Dropout_0`` scope path, so it draws the mask JAX's step draws for the
same key. JAX's step is ``make_train_step`` on a one-device CPU mesh with
the plain Flax module (``train_forward_impl="parity"`` semantics).

Tolerances: loss and metric rel 1e-5; eval-mode probabilities atol 1e-6;
BN statistics atol 1e-6; parameters after 1 and 3 steps atol 1e-5 (Adam
at lr 1e-3; SGD at its Keras default 0.01); optimizers on fixed gradients
atol 1e-6.

Batch-statistics probabilities: atol 1e-4. var = E[x^2] - E[x]^2 at 2-8
channels goes through rsqrt(var + 1e-3), which passes on the float32
summation order of both means (measured: 2.4e-5).

Gradients per tensor: max|d| <= 5e-4 * max|g| + 1e-7, not 1e-4: held
against the same step in float64 (``test_gradients_against_float64``),
the port's float32 gradients are within 2e-5 * max|g| and JAX's only
within 5e-4 * max|g| (XLA's CPU reductions of the batch statistics over
3072 pixels sum in sequence).

One trap forces a looser bound. The bias of a conv that feeds a
batch-statistics BatchNorm has an exact gradient of 0 (the BN subtracts
the batch mean); both frameworks return float noise there (|g| <= 1e-6 *
max|g|), and Adam normalises that noise to steps of up to lr. Those
biases are checked to move by at most lr per step, and their block's
running mean (which sees the bias) within 1e-5 plus 0.01 * steps * the
bias difference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops import bn_refresh as jax_bn
from oct_image_segmentation_models_tpu.ops import losses as jl
from oct_image_segmentation_models_tpu.ops import metrics as jm
from oct_image_segmentation_models_tpu.ops.s2d_train import _DropoutShim
from oct_image_segmentation_models_tpu.parallel import train_step as jts
from oct_image_segmentation_models_tpu.parallel.mesh import create_mesh
from oct_image_segmentation_models_torch.common.model_io import state_dict_from_flax
from oct_image_segmentation_models_torch.models import get_model_class as port_model_class
from oct_image_segmentation_models_torch.models import unet as port_unet
from oct_image_segmentation_models_torch.ops import bn_refresh as port_bn
from oct_image_segmentation_models_torch.ops import losses as tl
from oct_image_segmentation_models_torch.ops import metrics as tm
from oct_image_segmentation_models_torch.parallel import train_step as tts

from synth import make_layered_sample

H, W, C, B = 32, 48, 3, 2
CONFIG = dict(
    input_channels=1, num_classes=C, image_height=H, image_width=W,
    start_neurons=2, pool_layers=2,
)
RTOL = 1e-5
PROB_ATOL = 1e-6
# Train mode: batch-statistics BN in float32 (var = E[x^2] - E[x]^2 summed
# in another order, through rsqrt(var + 1e-3)) at 2-8 channels.
TRAIN_PROB_ATOL = 1e-4
STAT_ATOL = 1e-6
PARAM_ATOL = 1e-5
GRAD_REL, GRAD_ABS = 5e-4, 1e-7
OPT_ATOL = 1e-6


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for _ in range(n):
        img, lab, _ = make_layered_sample(rng, H, W, C)
        images.append(img)
        labels.append(lab)
    x = (np.stack(images)[..., None] / 255.0).astype(np.float32)
    return x, np.stack(labels)[..., None].astype(np.int32)


@pytest.fixture(scope="module")
def model():
    """(JAX module, JAX variables as numpy)."""
    module = jax_model_class("unet")(**CONFIG).build_model()
    variables = jax.jit(
        lambda k: module.init(k, jnp.zeros((1, H, W, 1)), training=False)
    )(jax.random.PRNGKey(3))
    return module, jax.tree_util.tree_map(np.asarray, dict(variables))


def _port_module(variables):
    module = port_model_class("unet")(**CONFIG).build_model(device="cpu")
    module.load_state_dict(state_dict_from_flax(variables))
    return module


def _jax_mask(key, shape_nchw):
    """JAX's bottleneck dropout mask for ``key``, as the port's NCHW bool."""
    b, c, h, w = shape_nchw
    out = _DropoutShim().apply(
        {}, jnp.ones((b, h, w, c)), training=True, rngs={"dropout": key}
    )
    return torch.from_numpy(np.asarray(out) != 0).permute(0, 3, 1, 2)


@pytest.fixture
def jax_masks(monkeypatch):
    """Replace the port's mask function by JAX's masks for the keys put in
    the returned list, one key per forward, in order."""
    keys = []

    def mask(x, generator):
        return _jax_mask(keys.pop(0), tuple(x.shape))

    monkeypatch.setattr(port_unet, "dropout_mask", mask)
    return keys


def _state_dict_of(params, stats):
    return state_dict_from_flax(
        {
            "params": jax.tree_util.tree_map(np.asarray, params),
            "batch_stats": jax.tree_util.tree_map(np.asarray, stats),
        }
    )


def _pre_bn_bias(key):
    return key.startswith("blocks.") and key.endswith(".conv.bias")


def _check_grad(got, want, key):
    err = float((got - want).abs().max())
    assert err <= GRAD_REL * float(want.abs().max()) + GRAD_ABS, (key, err)


def _loss_pair(name):
    sparse = jl.custom_loss_objects[name]["takes_sparse"]
    make = dict(num_classes=C, is_y_true_sparse=sparse)
    return (
        sparse,
        jl.custom_loss_objects[name]["function"](**make),
        tl.custom_loss_objects[name]["function"](**make),
    )


def _labels(labels, sparse):
    return labels if sparse else np.eye(C, dtype=np.float32)[labels[..., 0]]


def test_train_forward_probs_bn_stats_and_grads(model, jax_masks):
    jmod, variables = model
    x, labels = _batch(1)
    key = jax.random.PRNGKey(7)
    _, jloss, tloss = _loss_pair("focal_dice_loss")

    def jax_loss(params):
        out, mut = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), training=True, rngs={"dropout": key},
            mutable=["batch_stats"],
        )
        return jloss(jnp.asarray(labels), out), (out, mut["batch_stats"])

    (jv, (jout, jstats)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"]
    )

    module = _port_module(variables).train()
    jax_masks.append(key)
    out = module(torch.from_numpy(x), generator=None)
    loss = tloss(torch.from_numpy(labels), out)
    loss.backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=TRAIN_PROB_ATOL)
    assert abs(float(loss) - float(jv)) <= RTOL * abs(float(jv))
    want_sd = _state_dict_of(variables["params"], jstats)
    got_sd = module.state_dict()
    for k in want_sd:
        if "running" in k:
            np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), atol=STAT_ATOL, err_msg=k)
    jg = _state_dict_of(jgrads, variables["batch_stats"])
    gmax = max(float(g.abs().max()) for g in jg.values())
    for name, p in module.named_parameters():
        if _pre_bn_bias(name):
            # exact gradient 0: float noise in both
            assert float(p.grad.abs().max()) <= 1e-6 * gmax, name
            assert float(jg[name].abs().max()) <= 1e-6 * gmax, name
        else:
            _check_grad(p.grad, jg[name], name)


def test_gradients_against_float64(model, jax_masks):
    """The float32 gradients of the port and of JAX against the port's
    float64 gradients of the same step (the module in float64; the loss
    in float32 as JAX computes it): the port within 2e-5 and JAX within
    5e-4 of each tensor's largest gradient."""
    jmod, variables = model
    x, labels = _batch(1)
    key = jax.random.PRNGKey(7)
    _, jloss, tloss = _loss_pair("focal_dice_loss")

    def jax_loss(params):
        out, _ = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), training=True, rngs={"dropout": key}, mutable=["batch_stats"],
        )
        return jloss(jnp.asarray(labels), out)

    jg = _state_dict_of(jax.jit(jax.grad(jax_loss))(variables["params"]), variables["batch_stats"])
    grads = {}
    for dtype in (torch.float32, torch.float64):
        module = _port_module(variables).to(dtype).train()
        jax_masks.append(key)
        tloss(torch.from_numpy(labels), module(torch.from_numpy(x))).backward()
        grads[dtype] = {k: p.grad.double() for k, p in module.named_parameters()}
    worst_port, worst_jax = 0.0, 0.0
    for k, g64 in grads[torch.float64].items():
        if _pre_bn_bias(k):
            continue
        scale = float(g64.abs().max())
        worst_port = max(worst_port, float((grads[torch.float32][k] - g64).abs().max()) / scale)
        worst_jax = max(worst_jax, float((jg[k].double() - g64).abs().max()) / scale)
    assert worst_port <= 2e-5, worst_port
    assert worst_jax <= GRAD_REL, worst_jax


def test_stats_mode_and_eval_forward(model):
    """stats_mode: batch statistics and their running update with dropout
    off (JAX ``stats_mode=True``); eval mode: the running statistics."""
    jmod, variables = model
    x, _ = _batch(2)
    jout, mut = jmod.apply(
        variables, jnp.asarray(x), training=False, stats_mode=True, mutable=["batch_stats"]
    )
    module = _port_module(variables).eval()
    with torch.no_grad():
        out = module(torch.from_numpy(x), stats_mode=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TRAIN_PROB_ATOL)
    want = _state_dict_of(variables["params"], mut["batch_stats"])
    for k, v in module.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=STAT_ATOL, err_msg=k)
    module = _port_module(variables).eval()
    with torch.no_grad():
        out = module(torch.from_numpy(x))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jmod.apply(variables, jnp.asarray(x), training=False)),
        atol=PROB_ATOL,
    )


def _check_params(got_sd, want_sd, steps, lr):
    bias_err = {}
    for k, want in want_sd.items():
        if _pre_bn_bias(k):
            d = float((got_sd[k] - want).abs().max())
            assert d <= 2 * steps * lr + 1e-7, (k, d)
            bias_err[k[: -len("conv.bias")]] = d
    for k, want in want_sd.items():
        if _pre_bn_bias(k):
            continue
        atol = PARAM_ATOL
        if k.endswith("bn.running_mean"):
            atol += 0.01 * steps * bias_err[k[: -len("bn.running_mean")]]
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=atol, err_msg=k)


STEP_CASES = {
    "adam": ("focal_dice_loss", "dice_coef_macro"),
    "sgd": ("dice_loss_macro", "dice_coef_micro"),
}
MAX_STEPS = 3
STEP_KEYS = [jax.random.PRNGKey(100 + i) for i in range(MAX_STEPS)]
STEP_BATCHES = [_batch(10 + i) for i in range(MAX_STEPS)]
EVAL_BATCH = _batch(50)
_jax_runs = {}


def _jax_run(model, opt):
    """JAX's trajectory for ``opt``: after each step the state dict, loss,
    metric, and the eval step's (loss, metric) on ``EVAL_BATCH``; one
    compile per optimizer for the module."""
    if opt in _jax_runs:
        return _jax_runs[opt]
    jmod, variables = model
    loss_name, metric_name = STEP_CASES[opt]
    sparse, jloss, _ = _loss_pair(loss_name)
    jmetric = jm.training_monitor_metric_objects[metric_name](sparse, C)
    mesh = create_mesh(jax.devices()[:1])
    tx = jts.build_optimizer(opt, {})
    state = jts.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx, mesh)
    step = jts.make_train_step(jmod, tx, jloss, jmetric, mesh)
    evaluate = jts.make_eval_step(jmod, jloss, jmetric, mesh)
    ex, ey = EVAL_BATCH
    run = []
    for (x, y), key in zip(STEP_BATCHES, STEP_KEYS):
        state, lv, mv = step(state, jnp.asarray(x), jnp.asarray(_labels(y, sparse)), key)
        el, em = evaluate(state, jnp.asarray(ex), jnp.asarray(_labels(ey, sparse)))
        run.append(
            (_state_dict_of(state.params, state.batch_stats), float(lv), float(mv), float(el), float(em))
        )
    _jax_runs[opt] = run
    return run


@pytest.mark.parametrize("opt", list(STEP_CASES))
@pytest.mark.parametrize("steps", [1, MAX_STEPS])
def test_train_steps_match_jax(model, jax_masks, opt, steps):
    want = _jax_run(model, opt)[:steps]
    loss_name, metric_name = STEP_CASES[opt]
    sparse, _, tloss = _loss_pair(loss_name)
    tmetric = tm.training_monitor_metric_objects[metric_name](sparse, C)
    module = _port_module(model[1])
    state = tts.create_train_state(module, tts.build_optimizer(opt, {}))
    step = tts.make_train_step(module, tloss, tmetric)
    evaluate = tts.make_eval_step(module, tloss, tmetric)
    jax_masks.extend(STEP_KEYS[:steps])
    for (x, y), (_, wl, wm, _, _) in zip(STEP_BATCHES, want):
        state, lv, mv = step(
            state, torch.from_numpy(x), torch.from_numpy(_labels(y, sparse)), None
        )
        assert lv.ndim == 0 and mv.ndim == 0 and not lv.requires_grad
        assert abs(float(lv) - wl) <= RTOL * abs(wl) and abs(float(mv) - wm) <= RTOL * abs(wm)
    assert state.step == steps and not jax_masks
    want_sd, _, _, wl, wm = want[-1]
    lr = 1e-3 if opt == "adam" else 0.01
    _check_params(module.state_dict(), want_sd, steps, lr)

    ex, ey = EVAL_BATCH
    gl, gm = evaluate(state, torch.from_numpy(ex), torch.from_numpy(_labels(ey, sparse)))
    assert abs(float(gl) - wl) <= 1e-4 * abs(wl)
    assert abs(float(gm) - wm) <= 1e-4 * abs(wm) + 1e-6


def stub_mesh(nodes, local):
    """A mesh of ``nodes`` x ``local`` ranks seen from rank 0, for the
    checks that read only its shape (no process group)."""
    return tts.mesh_lib.Mesh(nodes, local, 0, torch.device("cpu"))


def test_step_impls_and_mesh():
    """"auto" and "spmd" are the one-device step without a mesh;
    "shard_map" needs a mesh (a process group); "spmd" on more than one
    rank builds the global-batch step (``tests/test_torch_spmd_step.py``
    runs it); an unknown impl or a mesh of another type raises."""
    module = _port_module_random()
    fn = tl.dice_loss_macro(is_y_true_sparse=True, num_classes=C)
    for impl in ("auto", "spmd"):
        tts.make_train_step(module, fn, fn, impl=impl)
        tts.make_eval_step(module, fn, fn, impl=impl)
    for make in (tts.make_train_step, tts.make_eval_step):
        with pytest.raises(ValueError, match="needs a mesh"):
            make(module, fn, fn, impl="shard_map")
        for mesh in (stub_mesh(1, 2), stub_mesh(2, 1)):
            assert tts._resolve_impl(mesh, "spmd") == "global"
            assert callable(make(module, fn, fn, mesh=mesh, impl="spmd"))
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            make(module, fn, fn, mesh=object())
        with pytest.raises(ValueError, match="unknown train step impl"):
            make(module, fn, fn, impl="pmap")
    # one rank: "auto" and "spmd" are the one-device step, as in JAX
    for impl in ("auto", "spmd"):
        tts.make_train_step(module, fn, fn, mesh=stub_mesh(1, 1), impl=impl)


def _port_module_random():
    return port_model_class("unet")(**CONFIG).build_model(
        generator=torch.Generator().manual_seed(0), device="cpu"
    )


def test_input_transform_runs_inside_the_step():
    module = _port_module_random()
    seen = []

    def transform(generator, images, labels, choices):
        seen.append(choices.tolist())
        return images * 0.5, labels

    fn = tl.focal_dice_loss(num_classes=C)
    state = tts.create_train_state(module, tts.build_optimizer("adam", {}))
    step = tts.make_train_step(module, fn, tm.dice_coef_macro(True, C), input_transform=transform)
    x, y = _batch(3)
    gen = torch.Generator().manual_seed(1)
    step(state, torch.from_numpy(x), torch.from_numpy(y), gen, torch.tensor([0, -1]))
    assert seen == [[0, -1]]


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_steps_and_refresher_turn_tf32_off_themselves():
    """train_step (forward and backward), eval_step and BNRefresher run in
    full float32 under a caller's TF32 settings, and put them back."""
    module = _port_module_random()
    seen = []
    module.head.register_forward_hook(lambda m, i, o: seen.append(("forward", _tf32_flags())))
    module.head.register_full_backward_hook(lambda m, gi, go: seen.append(("backward", _tf32_flags())))
    fn = tl.focal_dice_loss(num_classes=C)
    state = tts.create_train_state(module, tts.build_optimizer("adam", {}))
    x, y = (torch.from_numpy(a) for a in _batch(4))
    prev = _tf32_flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tts.make_train_step(module, fn, tm.dice_coef_macro(True, C))(state, x, y, None)
        tts.make_eval_step(module, fn, fn)(state, x, y)
        port_bn.BNRefresher(module)(None, [x])
        port_bn.BNRefresher(module, deterministic=True)(None, [x])
        assert _tf32_flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert [name for name, _ in seen] == ["forward", "backward"] + ["forward"] * 3
    assert all(flags == (False, False) for _, flags in seen), seen


def test_on_phase_marks_the_steps_split():
    module = _port_module_random()
    fn = tl.focal_dice_loss(num_classes=C)
    state = tts.create_train_state(module, tts.build_optimizer("adam", {}))
    step = tts.make_train_step(module, fn, tm.dice_coef_macro(True, C))
    x, y = (torch.from_numpy(a) for a in _batch(5))
    marks = []

    def on_phase(name):
        grads = [p.grad for p in module.parameters()]
        marks.append((name, all(g is not None for g in grads), state.optimizer.state != {}))

    step(state, x, y, None, on_phase=on_phase)
    # the gradients exist from the backward on, the optimizer state from its step
    assert marks == [("forward", False, False), ("backward", True, False), ("optimizer", True, True)]
    assert state.step == 1


OPTIMIZER_CASES = [
    ("adam", {}),
    ("adam", {"beta_1": 0.8, "epsilon": 1e-6, "learning_rate": 0.01}),
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.05}),
    ("sgd", {}),
    ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {}),
    ("rmsprop", {"rho": 0.8, "momentum": 0.5, "centered": True}),
    ("rmsprop", {"eps_in_sqrt": False, "bias_correction": True, "initial_scale": 0.1}),
    ("adagrad", {}),
    ("adagrad", {"initial_accumulator_value": 0.0}),
    ("nadam", {}),
    ("adamax", {}),
    ("Adam", {"learning_rate": lambda count: 1e-3 / (1 + count)}),
]


@pytest.mark.parametrize("name,opt_params", OPTIMIZER_CASES)
def test_optimizers_match_optax(name, opt_params):
    rng = np.random.default_rng(11)
    params = {
        "a": rng.normal(size=(3, 4)).astype(np.float32),
        "b": rng.normal(size=(5,)).astype(np.float32),
    }
    grads = [
        {k: rng.normal(size=v.shape).astype(np.float32) * 10.0 ** -i for k, v in params.items()}
        for i in range(3)
    ]
    grads[1]["b"][:2] = 0.0  # zero entries: adagrad's empty accumulator
    tx = jts.build_optimizer(name, opt_params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tts.build_optimizer(name, opt_params)(list(tparams.values()))
    assert isinstance(opt, torch.optim.Optimizer)
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(
            tparams[k].detach().numpy(), np.asarray(jparams[k]), atol=OPT_ATOL, rtol=0, err_msg=k
        )


@pytest.mark.parametrize(
    "name", ["adam", "adamw", "sgd", "rmsprop", "adagrad", "nadam", "adamax", "RMSprop"]
)
def test_resolved_optimizer_config_and_names(name):
    for opt_params in ({}, {"learning_rate": 0.02, "rho": 0.7, "beta_2": 0.99}):
        if name.lower() != "rmsprop":
            opt_params = {k: v for k, v in opt_params.items() if k != "rho"}
        if name.lower() in ("sgd", "rmsprop", "adagrad"):
            opt_params = {k: v for k, v in opt_params.items() if k != "beta_2"}
        assert tts.resolved_optimizer_config(name, opt_params) == jts.resolved_optimizer_config(
            name, opt_params
        )
    assert tts.KERAS_OPTIMIZER_NAMES == jts.KERAS_OPTIMIZER_NAMES


def test_build_optimizer_callable_and_unknown():
    factory = tts.build_optimizer(
        lambda learning_rate, b1: functools.partial(torch.optim.Adam, lr=learning_rate, betas=(b1, 0.9)),
        {"learning_rate": 0.1, "beta_1": 0.5},
    )
    opt = factory([torch.nn.Parameter(torch.zeros(2))])
    assert opt.param_groups[0]["lr"] == 0.1 and opt.param_groups[0]["betas"] == (0.5, 0.9)
    assert tts.resolved_optimizer_config(tts.adam, {"x": 1}) == {"x": 1}
    with pytest.raises(ValueError, match="Unknown optimizer"):
        tts.build_optimizer("lamb", {})
    # optax's low-precision first moment (test_torch_bf16_training.py holds
    # its trajectory against optax's)
    param = torch.nn.Parameter(torch.ones(2))
    opt = tts.build_optimizer("adam", {"mu_dtype": "bfloat16"})([param])
    param.grad = torch.full((2,), 0.5)
    opt.step()
    assert opt.state[param]["mu"].dtype == torch.bfloat16
    assert opt.state[param]["nu"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="mask"):
        tts.build_optimizer("adamw", {"mask": lambda p: p})


@pytest.mark.parametrize("deterministic", [True, False])
def test_bn_refresher_matches_jax(model, jax_masks, deterministic):
    jmod, variables = model
    batches = [_batch(30 + i)[0] for i in range(3)]
    key = jax.random.PRNGKey(5)
    want = jax_bn.compute_precise_batch_stats(
        jmod, variables["params"], variables["batch_stats"],
        [jnp.asarray(b) for b in batches], key, deterministic=deterministic,
    )
    want = _state_dict_of(variables["params"], want)
    module = _port_module(variables)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    if not deterministic:
        jax_masks.extend(jax.random.fold_in(key, i) for i in range(len(batches)))
    got = port_bn.compute_precise_batch_stats(
        module, None, [torch.from_numpy(b) for b in batches], deterministic=deterministic
    )
    assert not jax_masks
    assert set(got) == {k for k in want if "running" in k}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=STAT_ATOL, rtol=1e-5, err_msg=k)
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), f"{k} changed by the refresh"


def test_bn_refresher_takes_params_and_refuses_cross_process(model):
    _, variables = model
    module = _port_module(variables)
    other = _port_module_random().state_dict()
    batches = [torch.from_numpy(_batch(40)[0])]
    refresher = port_bn.BNRefresher(module, deterministic=True)
    got = refresher(other, batches)
    want = port_bn.BNRefresher(_port_module_random(), deterministic=True)(None, batches)
    for k in want:
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match=">= 1 batch"):
        refresher(None, [])
    with pytest.raises(ValueError, match="initialised process group"):
        refresher(None, batches, cross_process=True)
