"""The port's Keras import and export (``common/model_io.py``) against the
JAX package's, from bridged weights.

Seeded U-Net (32x48, start_neurons 2, pool_layers 2) and DeepLabV3+
(32x32, 3 channels) weights, their BatchNorm statistics drawn at random,
go to both packages (the JAX side through ``flax_from_state_dict``):

- ``save_keras_weights`` writes the same file in both: the same groups,
  layer and weight names, attributes and sidecar, every value bit for bit;
- the port's ``load_keras_unet_model`` / ``load_keras_deeplab_model`` (and
  ``load_model_and_config``'s dispatch to them) read that file into the
  state dict that JAX's import bridges to, and the forwards agree within
  ``FORWARD_ATOL``;
- ``load_keras_resnet50_weights`` on a ResNet50 fixture written here takes
  the same values as JAX's, and the DeepLab container's
  ``apply_pretrained_weights`` puts them where JAX's does; ``train_model``
  at learning rate 0 keeps them (JAX's
  ``test_deeplab_pretrained_backbone_wiring``).
"""

import json

import h5py
import jax
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_tpu.common import model_io as jax_model_io
from oct_image_segmentation_models_tpu.models import get_model_class as jax_model_class
from oct_image_segmentation_models_torch.common import model_io
from oct_image_segmentation_models_torch.models import get_model_class
from oct_image_segmentation_models_torch.training import TrainingParams, train_model

from synth import make_dataset
from torch_cpu import torch_threads  # noqa: F401 (the module's thread count)

# Two float32 forwards of the same weights, summed in another order.
FORWARD_ATOL = 1e-5
CONFIGS = {
    "unet": dict(input_channels=1, num_classes=3, image_height=32, image_width=48,
                 start_neurons=2, pool_layers=2),
    "deeplabv3plus": dict(input_channels=3, num_classes=3, image_height=32, image_width=32),
}


@pytest.fixture(scope="module")
def models():
    """{name: (container config, state_dict)} with random BN statistics."""
    out = {}
    for seed, (name, config) in enumerate(CONFIGS.items()):
        container = get_model_class(name)(**config)
        module = container.build_model(
            generator=torch.Generator().manual_seed(seed), device="cpu"
        )
        rng = np.random.default_rng(seed)
        state = module.state_dict()
        for key, value in state.items():
            if key.endswith("running_mean"):
                value.copy_(torch.from_numpy(rng.normal(0, 0.1, value.shape).astype(np.float32)))
            elif key.endswith("running_var"):
                value.copy_(torch.from_numpy(rng.uniform(0.5, 2, value.shape).astype(np.float32)))
        out[name] = (container.get_config(), state)
    return out


def _h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: np.asarray(obj.attrs[k]) for k in obj.attrs}
            data = np.asarray(obj[()]) if isinstance(obj, h5py.Dataset) else None
            out[name] = (attrs, data)
        visit("/", f)
        f.visititems(visit)
    return out


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(autouse=True)
def jitted_jax_init(monkeypatch):
    """JAX's Keras import starts from ``module.init``, un-jitted, which
    compiles op by op (tens of seconds for a ResNet50); every value it makes
    is overwritten from the file, so the same init under ``jax.jit`` stands
    in for it."""

    def init(module, model_config):
        x = np.zeros(
            (1, model_config["image_height"], model_config["image_width"],
             model_config["input_channels"]),
            np.float32,
        )
        return jax.jit(lambda key: module.init(key, x, training=False))(jax.random.PRNGKey(0))

    monkeypatch.setattr(jax_model_io, "_init_flax_variables", init)


def _write_both(tmp_path, name, config, state):
    """The port's and JAX's Keras files of ``state``, each in its own
    directory with its sidecar."""
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
    port = model_io.save_keras_weights(tmp_path / "port" / "w.h5", name, config, state)
    jax_path = jax_model_io.save_keras_weights(
        tmp_path / "jax" / "w.h5", name, config, model_io.flax_from_state_dict(state)
    )
    return port, jax_path


@pytest.mark.parametrize("name", list(CONFIGS))
def test_keras_export_equals_jax(models, tmp_path, name):
    config, state = models[name]
    port, jax_path = _write_both(tmp_path, name, config, state)
    got, want = _h5_tree(port), _h5_tree(jax_path)
    assert list(got) == list(want)  # the same groups and datasets, in order
    for key, (attrs, data) in want.items():
        g_attrs, g_data = got[key]
        assert sorted(g_attrs) == sorted(attrs), key
        for a in attrs:
            assert g_attrs[a].dtype == attrs[a].dtype, (key, a)
            np.testing.assert_array_equal(g_attrs[a], attrs[a], err_msg=f"{key}@{a}")
        if data is not None:
            assert g_data.dtype == data.dtype and g_data.shape == data.shape, key
            np.testing.assert_array_equal(g_data, data, err_msg=key)
    assert (port.parent / "model_config.json").read_bytes() == (
        jax_path.parent / "model_config.json"
    ).read_bytes()
    if name == "deeplabv3plus":
        assert model_io._resnet50_pruned_layer_order() == (
            jax_model_io._resnet50_pruned_layer_order()
        )


def _jax_forward(name, config, variables, x):
    module = jax_model_class(name)(**config).build_model()
    return np.asarray(jax.jit(lambda v, x: module.apply(v, x, training=False))(variables, x))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_keras_import_equals_jax_bridged(models, tmp_path, name):
    config, state = models[name]
    _, path = _write_both(tmp_path, name, config, state)
    loader = {
        "unet": model_io.load_keras_unet_model,
        "deeplabv3plus": model_io.load_keras_deeplab_model,
    }[name]
    loaded, got_config = loader(path, device="cpu")
    jax_loaded, jax_config = jax_model_io.load_keras_model(path)
    assert got_config == jax_config
    jax_vars = jax.tree_util.tree_map(np.asarray, jax_loaded.variables)
    _assert_state_equal(loaded.module.state_dict(), model_io.state_dict_from_flax(jax_vars))
    _assert_state_equal(loaded.module.state_dict(), state)
    dispatched, _ = model_io.load_model_and_config(path, device="cpu")
    assert dispatched.name == loaded.name == name
    _assert_state_equal(dispatched.module.state_dict(), state)

    x = np.random.default_rng(3).random(
        (2, config["image_height"], config["image_width"], config["input_channels"]),
        dtype=np.float32,
    )
    with torch.inference_mode():
        got = loaded.module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _jax_forward(name, config, jax_vars, x), atol=FORWARD_ATOL)


def test_keras_import_layout_errors(models, tmp_path):
    config, state = models["unet"]
    _, path = _write_both(tmp_path, "unet", config, state)
    deeper = dict(config, pool_layers=3, image_height=32, image_width=48)
    with pytest.raises(ValueError, match="layout mismatch"):
        model_io.load_keras_unet_model(path, model_config=deeper, device="cpu")
    (tmp_path / "jax" / "model_config.json").unlink()
    with pytest.raises(FileNotFoundError, match="model_config.json"):
        model_io.load_keras_model(path, device="cpu")


@pytest.fixture(scope="module")
def resnet_h5(models, tmp_path_factory):
    """A Keras-layout ResNet50 file with seeded values for two layers
    (``conv1_conv`` and ``conv1_bn``), nested under ``model_weights``."""
    _, state = models["deeplabv3plus"]
    rng = np.random.default_rng(9)
    kernel = rng.normal(size=tuple(state["resnet50.conv1_conv.weight"].permute(2, 3, 1, 0).shape))
    path = tmp_path_factory.mktemp("resnet") / "resnet50_imagenet.h5"
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")
        g = root.create_group("conv1_conv").create_group("conv1_conv")
        g["kernel:0"] = kernel.astype(np.float32)
        g["bias:0"] = rng.normal(size=64).astype(np.float32)
        b = root.create_group("conv1_bn").create_group("conv1_bn")
        b["gamma:0"] = np.full(64, 2.0, np.float32)
        b["beta:0"] = rng.normal(size=64).astype(np.float32)
        b["moving_mean:0"] = np.full(64, 0.25, np.float32)
        b["moving_variance:0"] = np.full(64, 4.0, np.float32)
    return path, kernel.astype(np.float32)


def test_resnet50_import_and_pretrained_weights_as_jax(models, resnet_h5):
    path, kernel = resnet_h5
    config, state = models["deeplabv3plus"]
    variables = model_io.flax_from_state_dict(state)
    backbone = variables["params"]["resnet50"]
    got_params, got_stats = model_io.load_keras_resnet50_weights(backbone, path)
    want_params, want_stats = jax_model_io.load_keras_resnet50_weights(backbone, path)
    for tree_got, tree_want in ((got_params, want_params), (got_stats, want_stats)):
        flat_got = jax.tree_util.tree_leaves_with_path(tree_got)
        flat_want = jax.tree_util.tree_leaves_with_path(tree_want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (p, a), (_, b) in zip(flat_got, flat_want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))
    np.testing.assert_array_equal(got_params["conv1_conv"]["kernel"], kernel)
    assert sorted(got_stats) == ["conv1_bn"]

    with_weights = {**config, "pretrained_weights": str(path)}
    port = get_model_class("deeplabv3plus")(**with_weights).apply_pretrained_weights(
        {k: v.clone() for k, v in state.items()}
    )
    jax_vars = jax_model_class("deeplabv3plus")(**with_weights).apply_pretrained_weights(
        variables
    )
    _assert_state_equal(
        port, model_io.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax_vars))
    )
    assert torch.equal(port["resnet50.conv1_bn.running_var"], torch.full((64,), 4.0))
    changed = {k for k in state if not torch.equal(state[k], port[k])}
    assert changed == {
        "resnet50.conv1_conv.weight", "resnet50.conv1_conv.bias",
        "resnet50.conv1_bn.weight", "resnet50.conv1_bn.bias",
        "resnet50.conv1_bn.running_mean", "resnet50.conv1_bn.running_var",
    }


def test_train_model_starts_from_pretrained_backbone(resnet_h5, tmp_path):
    path, kernel = resnet_h5
    ds = make_dataset(tmp_path / "rgb.hdf5", n_train=2, n_val=2, n_test=2, h=32, w=32,
                      num_classes=3, seed=3)
    with h5py.File(ds, "r+") as f:
        for split in ("train", "val", "test"):
            images = f[f"{split}_images"][:]
            del f[f"{split}_images"]
            f[f"{split}_images"] = np.repeat(images, 3, axis=-1)
    folder = train_model(
        TrainingParams(
            model_architecture="deeplabv3plus", training_dataset_path=ds,
            initial_model=None, results_location=tmp_path, opt_con="adam",
            opt_params={"learning_rate": 0.0}, loss="dice_loss_macro",
            metric="dice_coef_macro", epochs=1, batch_size=2,
            model_hyperparameters={"pretrained_weights": str(path)}, seed=0,
            device="cpu",
        )
    )
    _, config, state = model_io.load_checkpoint(folder / "model_final.hdf5")
    assert config["pretrained_weights"] == str(path)
    np.testing.assert_array_equal(
        state["resnet50.conv1_conv.weight"].permute(2, 3, 1, 0).numpy(), kernel
    )
    assert torch.equal(state["resnet50.conv1_bn.weight"], torch.full((64,), 2.0))
    assert json.loads((folder / "model_config.json").read_text())["pretrained_weights"] == str(path)
