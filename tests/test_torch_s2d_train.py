"""The port's space-to-depth training forward (``ops/s2d_train.py``)
against the JAX package's ``S2DTrainForward`` and against the port's own
parity U-Net, on the CPU.

Weights are the port's seeded init with the running statistics moved off
their init (``+ U(0.05, 0.15)``, as ``tests/test_s2d_train.py`` moves
them), carried to Flax (``flax_from_state_dict``). The port's dropout mask
is JAX's for the same key (``_DropoutShim``, as in
``tests/test_torch_train_step.py``). Bounds, each measured on the CPU:

- at JAX's two configs of ``tests/test_s2d_train.py`` (16x24 and 32x32),
  against JAX's s2d forward and against the port's parity module: the
  eval forward within 1e-6 (measured bit-equal to JAX's), the train-mode
  loss within 1e-6, the gradients within JAX's own ``gtol`` (2e-6, 3e-3;
  measured 3.9e-7 and 2.9e-4, the deeper config's float32 rounding
  amplified by stacked BatchNorms, as JAX's own s2d and parity forwards
  part by 2.4e-4), the new statistics within 1e-6;
- in float64, the port's s2d step against its parity step: loss within
  1e-10 relative, gradients within 1e-10 of each tensor's max (the pre-BN
  conv biases, whose exact gradient is 0, of the largest gradient's),
  statistics within 1e-10 (measured at most 4e-14);
- one Adam step of ``make_train_step`` over the s2d forward against JAX's
  over its s2d forward, held as ``test_torch_train_step.py`` holds the
  parity steps (``_check_params``), loss and metric rel 1e-5;
- ``BNRefresher`` over the s2d forward against JAX's, both modes: atol
  1e-6, rtol 1e-5;
- the bfloat16 forward against JAX's bfloat16 ``S2DTrainForward``: eval
  bit-equal, which pins XLA's roundings (the module docstring lists
  them). In batch-statistics mode the first block's statistics within
  1e-7 (measured 1.5e-8); past it, on most inputs the probabilities
  agree within 1.8e-7, but where a statistic summed in another order
  rounds ``scale`` or ``offset`` to the neighbouring bfloat16 value the
  flip carries (up to 0.026 on this test's input). So the port's mean
  error against the float64 forward, and its statistics' worst relative
  error, are held within 1.05 times JAX's (measured at most 1.0003 times
  over 8 seeded inputs);
- ``maybe_build_s2d_train`` refuses what JAX's refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops import bn_refresh as jax_bn
from oct_image_segmentation_models_tpu.ops import metrics as jm
from oct_image_segmentation_models_tpu.ops import s2d_train as jst
from oct_image_segmentation_models_tpu.parallel import train_step as jts
from oct_image_segmentation_models_tpu.parallel.mesh import create_mesh
from oct_image_segmentation_models_torch.common.model_io import flax_from_state_dict
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.ops import bn_refresh as port_bn
from oct_image_segmentation_models_torch.ops import metrics as tm
from oct_image_segmentation_models_torch.ops.s2d_train import (
    S2DTrainForward,
    maybe_build_s2d_train,
)
from oct_image_segmentation_models_torch.parallel import train_step as tts

from test_torch_train_step import (
    CONFIG,
    RTOL,
    STAT_ATOL,
    _batch,
    _check_params,
    _jax_mask,
    _loss_pair,
    _pre_bn_bias,
    _state_dict_of,
    jax_masks,  # noqa: F401 (fixture)
)
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

TOL = 1e-6
F64_TOL = 1e-10
BF16_TOL = 1e-7
BF16_ACCURACY = 1.05
CONFIGS = {
    "shallow": (dict(start_neurons=4, pool_layers=2, conv_layers=2, num_classes=3, h=16, w=24), 2e-6),
    "deeper": (dict(start_neurons=8, pool_layers=3, conv_layers=2, num_classes=4, h=32, w=32), 3e-3),
}
DROPOUT_KEY = jax.random.PRNGKey(42)


def _container_config(cfg, dtype=None):
    config = dict(
        input_channels=1, num_classes=cfg["num_classes"], image_height=cfg["h"],
        image_width=cfg["w"], start_neurons=cfg["start_neurons"],
        pool_layers=cfg["pool_layers"], conv_layers=cfg["conv_layers"],
    )
    if dtype is not None:
        config["dtype"] = dtype
    return config


def _port(config, seed=0):
    """The port's seeded U-Net, its statistics moved off their init."""
    module = get_model_class("unet")(**config).build_model(
        generator=torch.Generator().manual_seed(seed), device="cpu"
    )
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _, buf in module.named_buffers():
            buf.add_(torch.from_numpy(rng.uniform(0.05, 0.15, buf.shape).astype(np.float32)))
    return module


def _inputs(cfg):
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (2, cfg["h"], cfg["w"], 1)).astype(np.float32)
    labels = rng.integers(0, cfg["num_classes"], (2, cfg["h"], cfg["w"]))
    return x, np.eye(cfg["num_classes"], dtype=np.float32)[labels]


def _xent(onehot, out):
    return -(onehot * torch.log(out + 1e-7)).mean()


def _port_step(forward, module, x, onehot):
    """Loss, gradients and new statistics of one train-mode forward."""
    module.zero_grad(set_to_none=True)
    forward.train()
    loss = _xent(onehot, forward(x))
    loss.backward()
    forward.eval()
    grads = {k: p.grad.clone() for k, p in module.named_parameters()}
    stats = {k: b.clone() for k, b in module.named_buffers()}
    return float(loss.detach()), grads, stats


_jax_runs = {}


def _jax_run(name):
    """JAX's s2d forward on ``name``'s config: eval probabilities, and the
    train-mode loss, gradients and new statistics (as a state dict)."""
    if name in _jax_runs:
        return _jax_runs[name]
    cfg, _ = CONFIGS[name]
    config = _container_config(cfg)
    variables = flax_from_state_dict(_port(config).state_dict())
    fwd = jst.S2DTrainForward(config)
    x, onehot = (jnp.asarray(a) for a in _inputs(cfg))
    ev = jax.jit(lambda v: fwd.apply(v, x, training=False))(variables)

    def loss(params):
        out, mut = fwd.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x, training=True,
            rngs={"dropout": DROPOUT_KEY}, mutable=["batch_stats"],
        )
        return -(onehot * jnp.log(out + 1e-7)).mean(), mut["batch_stats"]

    (lv, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    _jax_runs[name] = (np.asarray(ev), float(lv), _state_dict_of(grads, stats))
    return _jax_runs[name]


def _bottleneck(cfg):
    n = cfg["pool_layers"]
    return (2, cfg["start_neurons"] * 2**n, cfg["h"] >> n, cfg["w"] >> n)


def _check_grads(got, want, tol):
    for k, g in want.items():
        err = float((got[k] - g).abs().max())
        assert err <= tol, (k, err)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_s2d_forward_matches_jax(name, jax_masks):
    cfg, gtol = CONFIGS[name]
    want_eval, want_loss, want = _jax_run(name)
    module = _port(_container_config(cfg))
    fwd = maybe_build_s2d_train(module, _container_config(cfg), cfg["h"], cfg["w"])
    x, onehot = (torch.from_numpy(a) for a in _inputs(cfg))
    with torch.no_grad():
        got_eval = fwd.eval()(x).numpy()
    np.testing.assert_allclose(got_eval, want_eval, atol=TOL)
    jax_masks.append(DROPOUT_KEY)
    loss, grads, stats = _port_step(fwd, module, x, torch.from_numpy(_inputs(cfg)[1]))
    assert not jax_masks
    assert abs(loss - want_loss) <= TOL, (loss, want_loss)
    _check_grads(grads, {k: v for k, v in want.items() if "running" not in k}, gtol)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_s2d_forward_matches_parity(name, monkeypatch):
    cfg, gtol = CONFIGS[name]
    x, onehot = (torch.from_numpy(a) for a in _inputs(cfg))
    mask = _jax_mask(DROPOUT_KEY, _bottleneck(cfg))
    from oct_image_segmentation_models_torch.models import unet

    monkeypatch.setattr(unet, "dropout_mask", lambda x, generator: mask)
    runs = []
    for s2d in (False, True):
        module = _port(_container_config(cfg))
        fwd = S2DTrainForward(module) if s2d else module
        with torch.no_grad():
            ev = fwd.eval()(x)
        runs.append((ev,) + _port_step(fwd, module, x, onehot))
    (ev_p, loss_p, grads_p, stats_p), (ev_s, loss_s, grads_s, stats_s) = runs
    np.testing.assert_allclose(ev_s.numpy(), ev_p.numpy(), atol=TOL)
    assert abs(loss_s - loss_p) <= TOL
    _check_grads(grads_s, grads_p, gtol)
    for k in stats_p:
        np.testing.assert_allclose(stats_s[k].numpy(), stats_p[k].numpy(), atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_float64_s2d_step_equals_parity_step(name):
    """The transform is exact algebra: in float64 no ReLU gate flips."""
    cfg, _ = CONFIGS[name]
    x, onehot = (torch.from_numpy(a).double() for a in _inputs(cfg))
    runs = []
    for s2d in (False, True):
        module = _port(_container_config(cfg)).double()
        fwd = S2DTrainForward(module) if s2d else module
        gen = torch.Generator().manual_seed(3)
        module.zero_grad(set_to_none=True)
        fwd.train()
        loss = _xent(onehot, fwd(x, generator=gen))
        loss.backward()
        runs.append((float(loss), {k: p.grad for k, p in module.named_parameters()},
                     dict(module.named_buffers())))
    (loss_p, grads_p, stats_p), (loss_s, grads_s, stats_s) = runs
    assert abs(loss_s - loss_p) <= F64_TOL * abs(loss_p)
    largest = max(float(g.abs().max()) for g in grads_p.values())
    for k, g in grads_p.items():
        scale = largest if _pre_bn_bias(k) else float(g.abs().max())
        assert float((grads_s[k] - g).abs().max()) <= F64_TOL * scale, k
    for k, v in stats_p.items():
        assert float((stats_s[k] - v).abs().max()) <= F64_TOL, k


def test_holds_the_parity_modules_own_tensors():
    module = _port(_container_config(CONFIGS["shallow"][0]))
    fwd = S2DTrainForward(module)
    assert list(fwd.state_dict()) == list(module.state_dict())
    for (kf, a), (km, b) in zip(fwd.state_dict(keep_vars=True).items(),
                                module.state_dict(keep_vars=True).items()):
        assert kf == km and a is b
    assert [id(p) for p in fwd.parameters()] == [id(p) for p in module.parameters()]
    stats = tts.batch_stats(fwd)
    assert stats.keys() == tts.batch_stats(module).keys()
    tts.load_batch_stats(fwd, {k: v + 1 for k, v in stats.items()})
    for k, v in tts.batch_stats(module).items():
        assert torch.equal(v, stats[k] + 1)
    assert flax_from_state_dict(fwd.state_dict()).keys() == {"params", "batch_stats"}
    assert fwd.compute_dtype == module.compute_dtype and fwd.s2d_levels == 2


def test_adam_step_matches_jax(jax_masks):
    """One step of ``make_train_step`` over the s2d forward, JAX's over
    its own, at the train-step test's U-Net (32x48, 3 classes, batch 2)."""
    port = get_model_class("unet")(**CONFIG).build_model(
        generator=torch.Generator().manual_seed(4), device="cpu"
    )
    variables = flax_from_state_dict(port.state_dict())
    sparse, jloss, tloss = _loss_pair("focal_dice_loss")
    x, y = _batch(20)
    key = jax.random.PRNGKey(21)
    mesh = create_mesh(jax.devices()[:1])
    tx = jts.build_optimizer("adam", {})
    jfwd = jst.S2DTrainForward(CONFIG)
    state = jts.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx, mesh)
    step = jts.make_train_step(jfwd, tx, jloss, jm.dice_coef_macro(sparse, 3), mesh)
    state, wl, wm = step(state, jnp.asarray(x), jnp.asarray(y), key)
    want = _state_dict_of(state.params, state.batch_stats)

    fwd = S2DTrainForward(port)
    tstate = tts.create_train_state(fwd, tts.build_optimizer("adam", {}))
    tstep = tts.make_train_step(fwd, tloss, tm.dice_coef_macro(sparse, 3))
    jax_masks.append(key)
    tstate, lv, mv = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y), None)
    assert not jax_masks and tstate.step == 1
    assert abs(float(lv) - float(wl)) <= RTOL * abs(float(wl))
    assert abs(float(mv) - float(wm)) <= RTOL * abs(float(wm))
    _check_params(port.state_dict(), want, 1, 1e-3)


@pytest.mark.parametrize("deterministic", [True, False])
def test_bn_refresher_over_s2d_matches_jax(jax_masks, deterministic):
    port = get_model_class("unet")(**CONFIG).build_model(
        generator=torch.Generator().manual_seed(5), device="cpu"
    )
    variables = flax_from_state_dict(port.state_dict())
    batches = [_batch(30 + i)[0] for i in range(2)]
    key = jax.random.PRNGKey(6)
    want = jax_bn.compute_precise_batch_stats(
        jst.S2DTrainForward(CONFIG), variables["params"], variables["batch_stats"],
        [jnp.asarray(b) for b in batches], key, deterministic=deterministic,
    )
    want = _state_dict_of(variables["params"], want)
    if not deterministic:
        jax_masks.extend(jax.random.fold_in(key, i) for i in range(len(batches)))
    got = port_bn.BNRefresher(S2DTrainForward(port), deterministic=deterministic)(
        None, [torch.from_numpy(b) for b in batches]
    )
    assert not jax_masks and set(got) == {k for k in want if "running" in k}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=STAT_ATOL, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_forward_matches_jax(name):
    cfg, _ = CONFIGS[name]
    config = _container_config(cfg, dtype="bfloat16")
    module = _port(config)
    variables = flax_from_state_dict(module.state_dict())
    x = _inputs(cfg)[0]
    jfwd = jst.S2DTrainForward(config, dtype=jnp.bfloat16)
    want_eval = np.asarray(jax.jit(lambda v: jfwd.apply(v, jnp.asarray(x), training=False))(variables))
    want, mut = jax.jit(
        lambda v: jfwd.apply(v, jnp.asarray(x), training=False, stats_mode=True,
                             mutable=["batch_stats"])
    )(variables)
    want, want_stats = np.asarray(want), _state_dict_of(variables["params"], mut["batch_stats"])
    fwd = S2DTrainForward(module).eval()
    ref_module = _port(_container_config(cfg)).double()
    with torch.no_grad():
        got_eval = fwd(torch.from_numpy(x)).numpy()
        got = fwd(torch.from_numpy(x), stats_mode=True).numpy()
        ref = S2DTrainForward(ref_module).eval()(torch.from_numpy(x).double(), stats_mode=True)
    assert np.array_equal(got_eval, want_eval)
    # Batch statistics: the first block sees the same input on both sides.
    first = "blocks.0.bn.running_mean"
    assert float((module.state_dict()[first] - want_stats[first]).abs().max()) <= BF16_TOL
    # Past it a statistic summed in another order can round scale or offset
    # to the neighbouring bfloat16 value, and the flip carries: hold the
    # port as accurate as JAX against the float64 forward.
    ref = ref.numpy()
    assert np.abs(got - ref).mean() <= BF16_ACCURACY * np.abs(want - ref).mean()
    ref_stats = dict(ref_module.named_buffers())

    def worst(stats):
        return max(float(((stats[k].double() - v).abs().max() / v.abs().max())) for k, v in ref_stats.items())

    assert worst(dict(module.named_buffers())) <= BF16_ACCURACY * worst(want_stats)


REFUSALS = {
    "eligible": ({}, (32, 48)),
    "odd conv_layers": ({"conv_layers": 3}, (32, 48)),
    "kernel over 3": ({"enc_kernel": (5, 5)}, (32, 48)),
    "height not divisible": ({}, (34, 48)),
    "width not divisible": ({}, (32, 50)),
    "wide levels only": ({"start_neurons": 128}, (32, 48)),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_maybe_build_refuses_as_jax(case):
    extra, (h, w) = REFUSALS[case]
    config = dict(CONFIG, image_height=h, image_width=w, **extra)
    jmodule = jax_model_class("unet")(**config).build_model()
    want = jst.maybe_build_s2d_train(jmodule, config, h, w)
    module = get_model_class("unet")(**config).build_model(device="cpu")
    got = maybe_build_s2d_train(module, config, h, w)
    assert (got is None) == (want is None), case
    if got is not None:
        assert got.s2d_levels == want.s2d_levels
        # Only a U-Net with a config qualifies.
        assert maybe_build_s2d_train(module, None, h, w) is None
        deeplab = get_model_class("deeplabv3plus")(
            input_channels=3, num_classes=3, image_height=h, image_width=w
        ).build_model(device="cpu")
        assert maybe_build_s2d_train(deeplab, config, h, w) is None
