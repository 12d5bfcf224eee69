"""bfloat16 training in the port against the JAX package's, on the CPU.

The U-Net of ``test_torch_train_step.py`` (32x48, 3 classes, batch 2,
start_neurons=2, pool_layers=2) with ``dtype="bfloat16"``, from a jitted
JAX init, bridged; the port's dropout mask is JAX's (``_DropoutShim``).

Tolerances, each measured on the CPU and stated here:

- one train-mode forward and backward (focal + Dice loss): the loss within
  1e-3 relative of JAX's (measured 1.7e-4). The gradients: bfloat16 flips
  roundings wherever the batch statistics, summed in another order, move
  a value across a rounding boundary, and the flips carry through the
  backward (JAX's own bfloat16 gradients lie 0.05-0.6 in relative L2 from
  the float64 step's). So per tensor the port's gradient lies within
  relative L2 ``GRAD_REL_L2`` = 0.6 of JAX's (measured at most 0.51); the
  head's and the last block's within 0.05 (measured at most 0.022); and,
  against the float64 step, the port's gradients are about as accurate as
  JAX's: their mean relative L2 error at most 1.5 times JAX's (measured
  0.258 against 0.211);
- the running statistics of that forward, float32: the first block's
  within 1e-6 of the tensor's largest value (it sees the same input;
  measured 3e-8), the others' within 5e-3 (measured at most 1.5e-3);
- Adam's, Nadam's and AdamW's ``mu_dtype`` and SGD's ``accumulator_dtype``
  in bfloat16: three steps on fixed gradients within 1e-6 of optax's
  (measured bit-equal, Nadam 2e-9), the slot stored in bfloat16;
- precise BatchNorm statistics of the bfloat16 module: float32, within
  5e-3 of the tensor's largest value from JAX's refresher on the same
  module;
- a JAX checkpoint written after one JAX Adam step of the bfloat16 module
  serves through the port's ``VolumeSegmenter(compute_dtype="bfloat16")``
  with JAX's labels on >= 99% of the pixels, and its rows are the plain
  min-path's on maps of its own labels;
- ``train_model`` trains a bfloat16 U-Net, fine-tunes a float32 checkpoint
  in bfloat16 and resumes a float32 train state in bfloat16 (JAX
  ``tests/test_training.py``); a bfloat16 run with bfloat16 Adam moments
  resumes bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oct_image_segmentation_models_tpu.common.model_io import load_model_and_config as jax_load
from oct_image_segmentation_models_tpu.common.model_io import save_model as jax_save_model
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_tpu.ops import bn_refresh as jax_bn
from oct_image_segmentation_models_tpu.prediction.streaming import (
    VolumeSegmenter as JaxVolumeSegmenter,
)
from oct_image_segmentation_models_torch.common import model_io
from oct_image_segmentation_models_torch.models import get_model_class as port_model_class
from oct_image_segmentation_models_torch.models import unet as port_unet
from oct_image_segmentation_models_torch.ops import boundary as tb
from oct_image_segmentation_models_torch.ops import minpath as tmp
from oct_image_segmentation_models_torch.ops.bn_refresh import compute_precise_batch_stats
from oct_image_segmentation_models_torch.parallel import train_step as tts
from oct_image_segmentation_models_torch.prediction.streaming import VolumeSegmenter
from oct_image_segmentation_models_torch.training import TrainingParams, train_model

from synth import make_dataset
from test_torch_train_step import (
    CONFIG,
    H,
    W,
    C,
    _batch,
    _jax_mask,
    _loss_pair,
    _pre_bn_bias,
    _state_dict_of,
)

BF16 = dict(CONFIG, dtype="bfloat16")
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 0.6
TAIL_GRAD_REL_L2 = 0.05
ACCURACY_RATIO = 1.5
FIRST_STAT_REL = 1e-6
STAT_REL = 5e-3
OPT_ATOL = 1e-6
MIN_AGREEMENT = 0.99


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_masks(monkeypatch):
    """The port's dropout masks are JAX's for the keys put in the list."""
    keys = []
    monkeypatch.setattr(
        port_unet, "dropout_mask", lambda x, generator: _jax_mask(keys.pop(0), tuple(x.shape))
    )
    return keys


@pytest.fixture(scope="module")
def jax_step():
    """The bfloat16 JAX module, its variables (numpy), the batch, the
    dropout key and JAX's loss, gradients and new statistics of one
    train-mode forward and backward."""
    jmod = jax_model_class("unet")(**BF16).build_model()
    variables = jax.tree_util.tree_map(
        np.asarray,
        dict(jax.jit(lambda k: jmod.init(k, jnp.zeros((1, H, W, 1)), training=False))(
            jax.random.PRNGKey(3)
        )),
    )
    x, labels = _batch(1)
    key = jax.random.PRNGKey(7)
    _, jloss, _ = _loss_pair("focal_dice_loss")

    def loss(params):
        out, mut = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            training=True, rngs={"dropout": key}, mutable=["batch_stats"],
        )
        return jloss(jnp.asarray(labels), out), mut["batch_stats"]

    (value, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return dict(module=jmod, variables=variables, x=x, labels=labels, key=key,
                loss=float(value), grads=grads, stats=stats)


def _port(variables, config=BF16):
    module = port_model_class("unet")(**config).build_model(device="cpu")
    module.load_state_dict(model_io.state_dict_from_flax(variables))
    return module


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _max_rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def test_bf16_train_step_matches_jax(jax_step, jax_masks):
    s = jax_step
    _, _, tloss = _loss_pair("focal_dice_loss")
    grads, losses, tail = {}, {}, ("head.",)
    for name, config, dtype in (("bf16", BF16, torch.float32), ("f64", CONFIG, torch.float64)):
        module = _port(s["variables"], config).to(dtype).train()
        jax_masks.append(s["key"])
        out = module(torch.from_numpy(s["x"]))
        assert out.dtype == dtype
        loss = tloss(torch.from_numpy(s["labels"]), out)
        loss.backward()
        losses[name] = float(loss)
        grads[name] = {k: p.grad for k, p in module.named_parameters()}
        if name == "bf16":
            tail += (f"blocks.{len(module.blocks) - 1}.",)
            assert module.compute_dtype == torch.bfloat16
            assert all(p.dtype == torch.float32 for p in module.parameters())
            want = _state_dict_of(s["variables"]["params"], s["stats"])
            for k, v in module.state_dict().items():
                if "running" in k:
                    assert v.dtype == torch.float32
                    bound = FIRST_STAT_REL if k.startswith("blocks.0.") else STAT_REL
                    assert _max_rel(v, want[k]) <= bound, (k, _max_rel(v, want[k]))
    assert abs(losses["bf16"] - s["loss"]) <= LOSS_RTOL * abs(s["loss"])
    jg = _state_dict_of(s["grads"], s["variables"]["batch_stats"])
    port_err, jax_err = [], []
    for k, g64 in grads["f64"].items():
        if _pre_bn_bias(k):
            continue  # exact gradient 0 (the BatchNorm takes the mean out)
        g = grads["bf16"][k]
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), k
        bound = TAIL_GRAD_REL_L2 if k.startswith(tail) else GRAD_REL_L2
        assert _rel(g, jg[k]) <= bound, (k, _rel(g, jg[k]))
        port_err.append(_rel(g, g64))
        jax_err.append(_rel(jg[k], g64))
    assert np.mean(port_err) <= ACCURACY_RATIO * np.mean(jax_err), (
        np.mean(port_err), np.mean(jax_err)
    )


SLOT_CASES = [
    ("adam", {"mu_dtype": "bfloat16"}),
    ("nadam", {"mu_dtype": "bfloat16"}),
    ("adamw", {"mu_dtype": "bfloat16", "weight_decay": 0.05}),
    ("sgd", {"momentum": 0.9, "accumulator_dtype": "bfloat16"}),
    ("sgd", {"momentum": 0.9, "nesterov": True, "accumulator_dtype": "bfloat16"}),
]


@pytest.mark.parametrize("name,opt_params", SLOT_CASES)
def test_low_precision_slots_match_optax(name, opt_params):
    rng = np.random.default_rng(11)
    params = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 0.3 for p in params] for _ in range(3)]
    hyper = {"learning_rate": 1e-2, **opt_params}
    jax_hyper = dict(hyper)
    for k in ("mu_dtype", "accumulator_dtype"):
        if k in jax_hyper:
            jax_hyper[k] = jnp.bfloat16
    tx = getattr(optax, name)(**jax_hyper)
    jparams = [jnp.asarray(p) for p in params]
    state = tx.init(jparams)
    for g in grads:
        updates, state = tx.update([jnp.asarray(a) for a in g], state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = getattr(tts, name)(**hyper)(tparams)
    for g in grads:
        for p, a in zip(tparams, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    slot = "mu" if "mu_dtype" in hyper else "trace"
    assert all(opt.state[p][slot].dtype == torch.bfloat16 for p in tparams)
    for got, want in zip(tparams, jparams):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=OPT_ATOL, rtol=0)
    # optax's slot holds the same bfloat16 values
    jslots = [leaf for leaf in jax.tree_util.tree_leaves(state) if leaf.dtype == jnp.bfloat16]
    for p, want in zip(tparams, jslots):
        np.testing.assert_array_equal(opt.state[p][slot].float().numpy(), np.asarray(want, np.float32))
    # a state dict round trip keeps the slot in bfloat16
    again = getattr(tts, name)(**hyper)(tparams)
    again.load_state_dict(opt.state_dict())
    assert all(again.state[p][slot].dtype == torch.bfloat16 for p in tparams)


def test_precise_bn_of_a_bf16_module_matches_jax(jax_step):
    s = jax_step
    batches = [_batch(30 + i)[0] for i in range(2)]
    want = jax_bn.compute_precise_batch_stats(
        s["module"], s["variables"]["params"], s["variables"]["batch_stats"],
        [jnp.asarray(b) for b in batches], jax.random.PRNGKey(5), deterministic=True,
    )
    want = _state_dict_of(s["variables"]["params"], want)
    got = compute_precise_batch_stats(
        _port(s["variables"]), None, [torch.from_numpy(b) for b in batches], deterministic=True
    )
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        assert _max_rel(v, want[k]) <= STAT_REL, (k, _max_rel(v, want[k]))


def test_jax_bf16_trained_checkpoint_serves_in_the_port(jax_step, tmp_path):
    s = jax_step
    tx = optax.adam(1e-2)
    params = s["variables"]["params"]
    updates, _ = tx.update(s["grads"], tx.init(params), params)
    trained = {"params": optax.apply_updates(params, updates), "batch_stats": s["stats"]}
    config = jax_model_class("unet")(**BF16).get_config()
    assert config["dtype"] == "bfloat16"
    path = tmp_path / "bf16.hdf5"
    jax_save_model(path, "unet", config, jax.tree_util.tree_map(np.asarray, trained))

    loaded, loaded_config = model_io.load_model_and_config(path, device="cpu")
    assert loaded_config["dtype"] == "bfloat16" and loaded.module.compute_dtype == torch.bfloat16
    want_state = model_io.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, trained))
    for k, v in loaded.module.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, want_state[k]), k
    volume = np.concatenate([_batch(40 + i, n=1)[0] for i in range(5)])
    volume = (volume * 255).round().astype(np.uint8)
    jloaded, jconfig = jax_load(path)
    jlabels, _ = JaxVolumeSegmenter(
        jloaded, jconfig, batch_size=2, compute_dtype="bfloat16"
    ).segment_volume(volume)
    seg = VolumeSegmenter(loaded, loaded_config, batch_size=2, compute_dtype="bfloat16", device="cpu")
    assert seg.kind == "s2d"
    labels, rows = seg.segment_volume(volume)
    assert (labels == np.asarray(jlabels)).mean() >= MIN_AGREEMENT
    maps = tb.boundary_maps_from_labels(torch.from_numpy(labels), C)
    want_rows = tmp.delineate_image_maps(maps, tie_parity="fast", backend="reference")
    np.testing.assert_array_equal(rows, want_rows.numpy().astype(np.uint16))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("torch_bf16_training") / "ds.hdf5", n_train=4)


def _params(dataset, folder, **kw):
    defaults = dict(
        model_architecture="unet", training_dataset_path=dataset, initial_model=None,
        results_location=folder, opt_con="adam", opt_params={"learning_rate": 1e-3},
        loss="dice_loss_macro", metric="dice_coef_macro", epochs=1, batch_size=2,
        model_hyperparameters={"start_neurons": 2, "pool_layers": 2}, seed=7, device="cpu",
        aug_mode="none",
    )
    defaults.update(kw)
    return TrainingParams(**defaults)


def _final(folder):
    return model_io.load_model_and_config(folder / "model_final.hdf5", device="cpu")


def test_train_model_in_bf16_and_from_float32(dataset, tmp_path):
    import h5py

    bf16 = {"start_neurons": 2, "pool_layers": 2, "dtype": "bfloat16"}
    folder = train_model(_params(
        dataset, tmp_path / "bf16", model_hyperparameters=bf16,
        opt_params={"learning_rate": 1e-3, "mu_dtype": "bfloat16"},
    ))
    loaded, config = _final(folder)
    assert config["dtype"] == "bfloat16" and loaded.module.compute_dtype == torch.bfloat16
    with h5py.File(folder / "training_params.hdf5", "r") as f:
        assert f.attrs["opt_param: mu_dtype"] == "bfloat16"

    # float32 -> bfloat16: fine-tune a checkpoint, resume a train state
    f32 = train_model(_params(dataset, tmp_path / "f32", train_state_checkpoint=True))
    assert "dtype" not in _final(f32)[1]
    for kw in (
        dict(initial_model=f32 / "model_final.hdf5"),
        dict(resume_train_state=f32 / "train_state_latest.npz", epochs=2,
             resume_config_check="warn"),
    ):
        out = train_model(_params(
            dataset, tmp_path / next(iter(kw)), model_architecture=None,
            model_hyperparameters={"dtype": "bfloat16"}, **kw,
        ))
        loaded, config = _final(out)
        assert config["dtype"] == "bfloat16" and loaded.module.compute_dtype == torch.bfloat16


def test_bf16_run_with_bf16_moments_resumes_bit_for_bit(dataset, tmp_path):
    kw = dict(
        model_hyperparameters={"start_neurons": 2, "pool_layers": 2, "dtype": "bfloat16"},
        opt_params={"learning_rate": 1e-3, "mu_dtype": "bfloat16"},
    )
    part = train_model(_params(dataset, tmp_path / "part", train_state_checkpoint=True, **kw))
    full = train_model(_params(dataset, tmp_path / "full", epochs=2, **kw))
    resumed = train_model(_params(
        dataset, tmp_path / "resumed", model_architecture=None, epochs=2,
        resume_train_state=part / "train_state_latest.npz", **kw,
    ))
    want, got = _final(full)[0].module.state_dict(), _final(resumed)[0].module.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
